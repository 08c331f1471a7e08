"""Sky-select emission path (reference-scale probes).

A terminal material (reflect ≡ transmit ≡ 0 — the sky enclosure,
/root/reference/src/test.cpp:134-140) zeroes a path's throughput on hit,
so at most one bounce per path contributes a nonzero terminal-emission
term; trace_rays exploits that to evaluate the sky's image chain on one
selected lane per (phase, path).  These tests pin:

- terminality detection in the material table compiler
- radiance parity sky-select vs the full-lane eval (same estimator,
  different floating-point summation order → tight-but-not-bitwise tol)
- gradient parity for the image + multiply-factor params (the whole
  point: the image cotangent rides ~Σ Bp lanes instead of Σ nb·Bp)
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.core import rng as prng
from ptx.integrate.camera import Camera, sample_rays
from ptx.integrate.trace import compile_scene, trace_rays
from ptx.scenes.builders import make_world, procedural_sky_image


@pytest.fixture(scope="module")
def scene():
    # a tall sky image (H=600): the reference-scale probe class
    # sky-select exists for
    return compile_scene(make_world(sky_image=procedural_sky_image(600, 256)))


def test_terminal_detection(scene):
    term = scene.material_fn.terminal_dynamic_emissive
    assert len(term) == 1, "demo scene has exactly one sky chain"
    # the glass/diffuse/emissive-core materials must NOT be terminal:
    # every other dynamic-emissive entry would appear here
    assert term[0][0] in scene.material_fn.dynamic_slots["emissive"]


def _render(scene, skysel, n=64, depth=8, compact=False):
    cam = Camera.reference_demo(32, 32)
    key = jax.random.PRNGKey(7)
    o, d = sample_rays(cam, key, jnp.arange(16), jnp.arange(32), 1)
    o = o.reshape(-1, 3)[:n]
    d = d.reshape(-1, 3)[:n]

    def loss(params):
        rad = trace_rays(scene, params, o, d, key, depth,
                         compact=compact, skysel=skysel)
        return jnp.sum(rad * rad), rad

    (val, rad), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(scene.params)
    return rad, val, grads


def test_radiance_and_grad_parity(scene):
    rad_on, val_on, g_on = _render(scene, skysel=True)
    rad_off, val_off, g_off = _render(scene, skysel=False)
    np.testing.assert_allclose(np.asarray(rad_on), np.asarray(rad_off),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_on["factor"]),
                               np.asarray(g_off["factor"]),
                               rtol=1e-4, atol=1e-6)
    for gi_on, gi_off in zip(g_on["images"], g_off["images"]):
        np.testing.assert_allclose(np.asarray(gi_on), np.asarray(gi_off),
                                   rtol=1e-4, atol=1e-6)
    # const-table parity EXCEPT the terminal material's own reflect /
    # transmit rows: the full-lane path keeps the gradient that flows
    # through zero-throughput continuations of a terminal hit
    # (d thr/d sky.reflect at reflect ≡ 0 — a real derivative of the
    # estimator); sky-select deliberately freezes it, treating the sky
    # enclosure's structural zeros as constants (README "Semantics and
    # deliberate deltas").  Nothing else may differ.
    mf = scene.material_fn
    frozen = set()
    for mi, _ in mf.terminal_dynamic_emissive:
        frozen.add(int(mf.const_idx["reflect"][mi]))
        frozen.add(int(mf.const_idx["transmit"][mi]))
    con, coff = np.asarray(g_on["const"]), np.asarray(g_off["const"])
    keep = np.array([i not in frozen for i in range(con.shape[0])])
    np.testing.assert_allclose(con[keep], coff[keep],
                               rtol=1e-4, atol=1e-6)
    assert np.all(con[~keep] == 0.0)


def test_parity_with_compaction(scene):
    # the select runs per phase — compaction reshapes the phases, so pin
    # parity with compact=True as well (phase widths 64 → 32 → 8)
    rad_on, _, _ = _render(scene, skysel=True, compact=True, depth=10)
    rad_off, _, _ = _render(scene, skysel=False, compact=True, depth=10)
    np.testing.assert_allclose(np.asarray(rad_on), np.asarray(rad_off),
                               rtol=1e-5, atol=1e-6)
