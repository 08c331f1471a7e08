"""Cross-check: the direct first-hit path (ptx.geom.fasthit) must agree
with the span-merge path (ptx.geom.spans + first_hit) on random rays over
random CSG scenes — including transforms, differences, and the sky-plane
MAX_VALUE sentinel semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.core import linalg
from ptx.geom.tape import (Difference, Intersection, Plane, Sphere,
                           Transformed, Union)
from ptx.integrate.trace import compile_scene, first_hit
from ptx.shade.materials import Material


def random_scene(rng, n_mats=3, depth=3):
    mats = [Material(reflect=0.5 + 0.1 * i, scatter=1.0)
            for i in range(n_mats)]

    def rand_leaf():
        if rng.uniform() < 0.7:
            return Sphere(rng.uniform(-3, 3, 3).astype(np.float32),
                          float(rng.uniform(0.4, 1.6)),
                          mats[rng.integers(n_mats)])
        n = rng.normal(size=3).astype(np.float32)
        return Plane(n, float(rng.uniform(-2, 2)),
                     mats[rng.integers(n_mats)])

    def rand_node(d):
        if d == 0 or rng.uniform() < 0.3:
            leaf = rand_leaf()
            if rng.uniform() < 0.25:
                t = np.asarray(linalg.translate(
                    rng.uniform(-0.5, 0.5, 3).astype(np.float32)))
                return Transformed(leaf, t)
            return leaf
        op = rng.integers(3)
        if op == 0:
            return Union(rand_node(d - 1), rand_node(d - 1))
        if op == 1:
            return Intersection(rand_node(d - 1), rand_node(d - 1))
        return Difference(rand_node(d - 1), rand_node(d - 1))

    return Union(rand_node(depth), rand_leaf())


def compare_paths(scene, o, d, atol=2e-3):
    fast = jax.jit(scene.hit_fn)(scene.params, o, d)
    slow = jax.jit(lambda p, o, d: first_hit(scene.spans_fn(p, o, d)))(
        scene.params, o, d)
    fast = {k: np.asarray(v) for k, v in fast.items()}
    slow = {k: np.asarray(v) for k, v in slow.items()}

    # ignore rays whose hit sits within atol of ANY other boundary — exact
    # tie handling (degenerate tangencies) differs by design
    agree_mask = fast["hit"] == slow["hit"]
    np.testing.assert_array_equal(fast["hit"].shape, slow["hit"].shape)
    frac = agree_mask.mean()
    assert frac > 0.98, f"hit flags disagree on {(1-frac)*100:.1f}% of rays"
    both = fast["hit"] & slow["hit"] & agree_mask
    close_t = np.abs(fast["t"][both] - slow["t"][both]) < atol * (
        1.0 + np.abs(slow["t"][both]))
    assert close_t.mean() > 0.98
    stable = both & (np.abs(fast["t"] - slow["t"]) < 1e-5)
    np.testing.assert_array_equal(fast["mat_id"][stable],
                                  slow["mat_id"][stable])
    np.testing.assert_array_equal(fast["entering"][stable],
                                  slow["entering"][stable])
    np.testing.assert_allclose(fast["normal"][stable],
                               slow["normal"][stable], atol=1e-4)


@pytest.mark.parametrize("seed", range(8))
def test_fast_vs_spans_random_scenes(seed):
    rng = np.random.default_rng(seed)
    scene = compile_scene(random_scene(rng))
    n = 256
    o = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    compare_paths(scene, o, d)


def test_fast_vs_spans_demo_world():
    from ptx.scenes.builders import make_world
    scene = compile_scene(make_world())
    rng = np.random.default_rng(42)
    n = 512
    d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  -np.ones(n)], -1).astype(np.float32)
    o = np.zeros_like(d)
    compare_paths(scene, jnp.asarray(o), jnp.asarray(d))


def test_fast_hit_sky_enclosure_never_misses():
    from ptx.scenes.builders import baseline_config1
    scene = compile_scene(baseline_config1())
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=(128, 3)).astype(np.float32))
    o = jnp.zeros((128, 3))
    h = jax.jit(scene.hit_fn)(scene.params, o, d)
    assert np.asarray(h["hit"]).all()     # closed sky box: every ray hits


def test_coincident_boundary_payload_prefers_deeper_leaf():
    """Regression for the reference demo's glass bulb: a sphere unioned
    with an identically-placed sphere nested deeper in the CSG tree must
    surface the DEEPER leaf's material at the shared boundary (the
    reference's nested merges coalesce payloads bottom-up; BASELINE.md
    'Golden parity')."""
    shallow = Material(reflect=0.8, scatter=1.0)            # mat id 0
    deep = Material(reflect=0.0, scatter=0.0, emissive=2.0)  # nested
    world = Union(
        Sphere((0.0, 0.0, -4.0), 0.5, shallow),
        Union(Plane((0.0, 0.0, -1.0), 100.0, shallow),
              Sphere((0.0, 0.0, -4.0), 0.5, deep)),
    )
    scene = compile_scene(world)
    o = jnp.zeros((4, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4, jnp.float32)
    # find deep material's table id by probing the material slots
    from ptx.shade.materials import assign_material_ids
    _, ids = assign_material_ids(world)
    deep_id = ids[id(deep)]

    h = jax.jit(scene.hit_fn)(scene.params, o, d)
    assert bool(np.asarray(h["hit"]).all())
    assert (np.asarray(h["mat_id"]) == deep_id).all()


@pytest.mark.parametrize("scene_name", ["config2", "demo"])
def test_hit_path_matches_spans_oracle_ragged_batch(scene_name):
    """The production first hit vs the span-merge reference on a ragged
    (260-lane) batch of rays from inside and around the geometry."""
    from ptx.scenes.builders import baseline_config2, make_world
    world = {"config2": baseline_config2, "demo": make_world}[scene_name]()
    scene = compile_scene(world)
    g = np.random.default_rng(0)
    n = 260
    o = jnp.asarray(g.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = jnp.asarray(g.normal(size=(n, 3)).astype(np.float32))
    compare_paths(scene, o, d)


def test_hit_grads_match_spans_path():
    """d(Σ t + Σ |n|²)/d(geometry) through the production hit path equals
    the same gradient through the span-merge reference (selection is
    piecewise constant; the payload math is differentiable in both)."""
    from ptx.scenes.builders import baseline_config2
    scene = compile_scene(baseline_config2())
    g = np.random.default_rng(1)
    n = 128
    o = jnp.zeros((n, 3))
    d = jnp.asarray(np.stack([g.uniform(-0.6, 0.6, n),
                              g.uniform(-0.6, 0.6, n),
                              -np.ones(n)], -1).astype(np.float32))

    def loss(h):
        return (jnp.sum(jnp.where(h["hit"], h["t"], 0.0))
                + jnp.sum(jnp.where(h["hit"][..., None], h["normal"],
                                    0.0) ** 2))

    ga = jax.jit(jax.grad(lambda p: loss(scene.hit_fn(p, o, d))))(
        scene.params)
    gb = jax.jit(jax.grad(lambda p: loss(first_hit(scene.spans_fn(
        p, o, d)))))(scene.params)
    for k in ("sphere_center", "sphere_radius", "plane_normal", "plane_d",
              "xform"):
        a, b = np.asarray(ga[k]), np.asarray(gb[k])
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, err_msg=k)
