"""The composed workload class: large CSG scene UNDER an HDR probe.

The reference demo's actual big-scene shape is ``unionArray`` CSG inside
an equirect-HDR sky enclosure (/root/reference/src/test.cpp:52-64,
97-105,123,134-140).  These tests run the large-scene machinery (union
sweep, compaction) and the image-sky machinery (sky-select emission, the
image gather's scatter-add transpose) in one program: the stress scenes'
sky planes carrying the demo's Multiply→SphericalCoords→ImageTex chain.

- sky-select on/off is radiance-EXACT on the composed scene (the
  terminal-chain argument of trace.py's post-scan block holds with the
  large scene + compaction active);
- gradients flow to the sky image (nonzero) and stay finite through
  compaction + manual VJP;
- a live bounce on the composed scene makes the same decisions as the
  same bounce over the span-merge reference (the image sky changes only
  EMISSIVE slots, never the geometry or the continuation).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.integrate import trace as tr
from ptx.scenes.builders import (procedural_sky_image, stress_gadgets,
                                 stress_spheres)


def _rays(B, seed=0):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 3, B),
                  np.full(B, 10.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.3, B),
                  -np.ones(B)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("builder,n", [(stress_spheres, 16),
                                       (stress_gadgets, 8)])
def test_composed_skysel_exact_and_grads_finite(builder, n):
    img = procedural_sky_image(32, 64)
    scene = tr.compile_scene(builder(n, sky_image=img))
    # the composed scene must route the same way the demo does: one
    # terminal dynamic emissive chain → sky-select + mat-sum
    assert len(scene.material_fn.terminal_dynamic_emissive) == 1

    B = 1024
    o, d = _rays(B, seed=3)
    key = jax.random.PRNGKey(5)

    def rad(skysel):
        return jax.jit(lambda p: tr.trace_rays(
            scene, p, o, d, key, 8, compact=True,
            skysel=skysel))(scene.params)

    r_sel = np.asarray(rad(True))
    r_all = np.asarray(rad(False))
    assert np.isfinite(r_sel).all()
    # sky-select is exact for radiance (at most one bounce per path
    # carries a nonzero terminal-emission term) — f32 summation-order
    # tolerance only
    np.testing.assert_allclose(r_sel, r_all, rtol=2e-5, atol=2e-6)

    def loss(p):
        return jnp.mean(tr.trace_rays(scene, p, o, d, key, 8,
                                      compact=True))

    v, g = jax.jit(jax.value_and_grad(loss))(scene.params)
    assert np.isfinite(float(v))
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    img_gsum = sum(float(jnp.abs(l).sum())
                   for l in jax.tree.leaves(g["images"]))
    assert img_gsum > 0.0, "sky image received no gradient"


@pytest.mark.parametrize("builder,n", [(stress_spheres, 25),
                                       (stress_gadgets, 12)])
def test_composed_bounce_matches_spans_oracle(builder, n):
    """One live bounce on the composed scene (union sweep + image sky)
    vs the same bounce over the span-merge reference: identical inputs
    and draws ⇒ identical decisions on all but measure-zero lanes, and
    ulp-tight hit distances."""
    img = procedural_sky_image(32, 64)
    scene = tr.compile_scene(builder(n, sky_image=img))
    oracle = tr.compile_scene(builder(n, sky_image=img), fast=False)
    assert oracle.hit_fn is None

    B = 512
    o, d = _rays(B, seed=1)
    key = jax.random.PRNGKey(7)
    carry = (o, d, jnp.ones((B, 3)), jnp.ones(B), jnp.ones(B, bool))
    _, dec_f = jax.jit(lambda p: tr._bounce_live(
        scene, p, *carry, key, True))(scene.params)
    _, dec_s = jax.jit(lambda p: tr._bounce_live(
        oracle, p, *carry, key, True))(oracle.params)
    agree = np.ones(B, bool)
    for kname in ("entering", "hit", "mat_id", "take_transmit",
                  "scatter_alive"):
        agree &= np.asarray(dec_f[kname]) == np.asarray(dec_s[kname])
    assert agree.mean() >= 0.995, float(agree.mean())
    assert np.asarray(dec_f["hit"]).sum() > 100
    ta, tb = np.asarray(dec_f["t"])[agree], np.asarray(dec_s["t"])[agree]
    np.testing.assert_allclose(ta, tb, rtol=2e-5, atol=1e-5)
