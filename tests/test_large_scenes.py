"""Arbitrary-scale scenes: the candidate-
blocked first-hit must agree with the span-merge oracle and the dense
path at unionArray-style leaf counts the reference's streaming handles
(/root/reference/src/union.cpp:84-134, test.cpp:52-64)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.geom.fasthit import (collect_leaves, compile_fast_hit,
                              tape_is_union_only, _DENSE_L_MAX)
from ptx.integrate.trace import compile_scene, first_hit, trace_rays
from ptx.scenes.builders import stress_spheres


def _rays(n, seed=0):
    g = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([g.uniform(-1.5, 1.5, n), g.uniform(-0.8, 0.5, n),
                  np.full(n, -1.0)], -1).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_hits_match(a, b, rtol=2e-5):
    np.testing.assert_array_equal(np.asarray(a["hit"]), np.asarray(b["hit"]))
    m = np.asarray(a["hit"])
    np.testing.assert_allclose(np.asarray(a["t"])[m], np.asarray(b["t"])[m],
                               rtol=rtol)
    np.testing.assert_array_equal(np.asarray(a["mat_id"])[m],
                                  np.asarray(b["mat_id"])[m])
    np.testing.assert_array_equal(np.asarray(a["entering"])[m],
                                  np.asarray(b["entering"])[m])
    # normals may differ by renormalization of already-unit vectors
    # (and fusion-order jitter in near-zero components)
    np.testing.assert_allclose(np.asarray(a["normal"])[m],
                               np.asarray(b["normal"])[m],
                               rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize("n", [57, 121])
def test_blocked_hit_matches_spans_oracle(n):
    world = stress_spheres(n)
    scene = compile_scene(world)
    L = len(collect_leaves(scene.plan))
    assert L == n + 7
    # force the blocked strategy regardless of the auto-pick (union-only
    # tapes now default to the sweep) — this test is about the blocked scan
    hit_fn = compile_fast_hit(scene.plan, candidate_block=32)
    o, d = _rays(256)
    got = jax.jit(hit_fn)(scene.params, o, d)
    want = first_hit(scene.spans_fn(scene.params, o, d))
    assert int(np.asarray(got["hit"]).sum()) > 50
    _assert_hits_match(got, want)


def test_blocked_hit_matches_dense_path():
    """Force both strategies on the same mid-size scene."""
    world = stress_spheres(20)                 # L = 27, just over dense max
    scene = compile_scene(world)
    dense = compile_fast_hit(scene.plan, candidate_block=0)   # force dense
    blocked = compile_fast_hit(scene.plan, candidate_block=8)
    o, d = _rays(512, seed=1)
    a = jax.jit(blocked)(scene.params, o, d)
    b = jax.jit(dense)(scene.params, o, d)
    _assert_hits_match(a, b)
    np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                  np.asarray(b["_evt"]))


def test_large_scene_renders_and_differentiates():
    """Full pipeline at L=64+: trace + manual-VJP gradients, finite."""
    world = stress_spheres(64)
    scene = compile_scene(world)
    o, d = _rays(128, seed=2)
    key = jax.random.PRNGKey(0)

    def loss(params):
        return jnp.mean(trace_rays(scene, params, o, d, key, depth=3))

    val, grads = jax.jit(jax.value_and_grad(loss))(scene.params)
    assert np.isfinite(float(val)) and float(val) > 0.01
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.abs(np.asarray(grads["sphere_radius"])).max() > 0


# ---------------------------------------------------------------------------
# union-sweep strategy (O(L log L) sorted-interval path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [57, 121])
def test_union_sweep_matches_spans_oracle(n):
    world = stress_spheres(n)
    scene = compile_scene(world)
    assert tape_is_union_only(scene.plan)
    hit_fn = compile_fast_hit(scene.plan, sweep=True)
    o, d = _rays(256)
    got = jax.jit(hit_fn)(scene.params, o, d)
    want = first_hit(scene.spans_fn(scene.params, o, d))
    assert int(np.asarray(got["hit"]).sum()) > 50
    _assert_hits_match(got, want)


def test_union_sweep_matches_dense_evt():
    """Event-for-event agreement with the dense fold — including the
    argmin tie-break order — on a scene with coincident boundaries
    (duplicated spheres) and rays from inside geometry."""
    from ptx.scenes.builders import union_array, sky_planes
    from ptx.geom.tape import Sphere, Plane
    from ptx.shade.materials import Material

    m1 = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    m2 = Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    world = union_array([
        Sphere((0.0, 0.0, -3.0), 1.0, m1),
        Sphere((0.0, 0.0, -3.0), 1.0, m2),      # identical — entry/exit ties
        Sphere((0.5, 0.0, -3.5), 1.0, m2),      # overlapping chain
        Sphere((0.0, 0.0, -5.0), 1.0, m1),      # touching along the axis
        Plane((0.0, 1.0, 0.0), 1.0, m1),
        *sky_planes(sky),
    ])
    scene = compile_scene(world)
    dense = compile_fast_hit(scene.plan, candidate_block=0, sweep=False)
    swept = compile_fast_hit(scene.plan, sweep=True)
    g = np.random.default_rng(3)
    # origins inside/outside the overlap region, axis-aligned + random dirs
    o = np.concatenate([np.zeros((256, 3)),
                        np.array([[0.0, 0.0, -3.0]] * 64),
                        g.uniform(-2, 2, (192, 3))]).astype(np.float32)
    d = np.concatenate([
        np.stack([g.uniform(-1, 1, 256), g.uniform(-1, 1, 256),
                  np.full(256, -1.0)], -1),
        np.array([[0.0, 0.0, -1.0]] * 64),
        g.normal(size=(192, 3)),
    ]).astype(np.float32)
    o, d = jnp.asarray(o), jnp.asarray(d)
    a = jax.jit(swept)(scene.params, o, d)
    b = jax.jit(dense)(scene.params, o, d)
    _assert_hits_match(a, b)
    np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                  np.asarray(b["_evt"]))


def test_union_sweep_auto_selected_and_differentiates():
    """compile_scene auto-picks the sweep for large union-only tapes; the
    full trace + manual-VJP pipeline stays finite through it."""
    world = stress_spheres(96)
    scene = compile_scene(world)
    # auto-pick: union-only and L=103 > _SWEEP_L_MIN → sweep, default
    # fixpoint mode (chain-exit while_loop; no global sort, no scan —
    # the blocked path's marker)
    jaxpr = jax.make_jaxpr(
        lambda p, o, d: scene.hit_fn(p, o, d)["t"])(
            scene.params, jnp.zeros((8, 3)), jnp.ones((8, 3)))
    assert "while" in str(jaxpr) and "sort[" not in str(jaxpr)
    o, d = _rays(128, seed=5)
    key = jax.random.PRNGKey(0)

    def loss(params):
        return jnp.mean(trace_rays(scene, params, o, d, key, depth=3))

    val, grads = jax.jit(jax.value_and_grad(loss))(scene.params)
    assert np.isfinite(float(val)) and float(val) > 0.01
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.abs(np.asarray(grads["sphere_radius"])).max() > 0


def test_demo_scene_is_not_union_only():
    from ptx.scenes.builders import make_world
    scene = compile_scene(make_world())
    assert not tape_is_union_only(scene.plan)


# ---------------------------------------------------------------------------
# group sweep: union of compound CSG gadgets (lenses / bulbs / differences)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 48])
def test_group_sweep_matches_spans_oracle(n):
    """Mixed-CSG big scenes (unionArray over compound solids — the
    reference's test.cpp:52-64,126-144 shape) take the sorted-interval
    sweep: compound groups' coverage intervals come from local membership
    folds + rank pairing.  Must agree with the span-merge oracle."""
    from ptx.scenes.builders import stress_gadgets
    world = stress_gadgets(n)
    scene = compile_scene(world)
    assert not tape_is_union_only(scene.plan)
    hit_fn = compile_fast_hit(scene.plan, sweep=True)
    o, d = _rays(384)
    got = jax.jit(hit_fn)(scene.params, o, d)
    want = first_hit(scene.spans_fn(scene.params, o, d))
    assert int(np.asarray(got["hit"]).sum()) > 100
    _assert_hits_match(got, want)


def test_group_sweep_matches_dense_evt():
    """Event-for-event agreement with the dense fold on compound groups,
    including difference-cut boundaries (an ENTERING root boundary
    generated by a leaf END event) and rays originating inside gadgets."""
    from ptx.scenes.builders import stress_gadgets
    world = stress_gadgets(9, seed=4)
    scene = compile_scene(world)
    dense = compile_fast_hit(scene.plan, candidate_block=0, sweep=False)
    swept = compile_fast_hit(scene.plan, sweep=True)
    g = np.random.default_rng(7)
    o = np.concatenate([np.zeros((256, 3)),
                        g.uniform(-3, 3, (256, 3))]).astype(np.float32)
    o[:, 2] -= 2.0
    d = np.concatenate([
        np.stack([g.uniform(-1, 1, 256), g.uniform(-1, 0.2, 256),
                  np.full(256, -1.0)], -1),
        g.normal(size=(256, 3)),
    ]).astype(np.float32)
    o, d = jnp.asarray(o), jnp.asarray(d)
    a = jax.jit(swept)(scene.params, o, d)
    b = jax.jit(dense)(scene.params, o, d)
    _assert_hits_match(a, b)
    np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                  np.asarray(b["_evt"]))
    # difference-cut payloads must actually be exercised (end-generated
    # boundaries: evt >= L on hit lanes)
    L = len(collect_leaves(scene.plan))
    m = np.asarray(a["hit"])
    assert (np.asarray(a["_evt"])[m] >= L).any()


def test_group_sweep_auto_selected_and_differentiates():
    """compile_scene auto-picks the sweep for big mixed-CSG scenes; the
    full trace + manual-VJP pipeline stays finite through it."""
    from ptx.geom.fasthit import union_decompose, _SWEEP_L_MIN
    from ptx.scenes.builders import stress_gadgets
    world = stress_gadgets(24)
    scene = compile_scene(world)
    L = len(collect_leaves(scene.plan))
    assert L > _SWEEP_L_MIN and len(union_decompose(scene.plan)) == 31
    # auto-pick lands on the sweep (fixpoint): compound groups still sort
    # locally for rank pairing, the chain walk is a while_loop, and there
    # is no lax.scan (the blocked path's marker)
    jaxpr = str(jax.make_jaxpr(
        lambda p, o, d: scene.hit_fn(p, o, d)["t"])(
            scene.params, jnp.zeros((8, 3)), jnp.ones((8, 3))))
    assert "sort[" in jaxpr and "while" in jaxpr and "scan" not in jaxpr
    o, d = _rays(128, seed=6)
    key = jax.random.PRNGKey(0)

    def loss(params):
        return jnp.mean(trace_rays(scene, params, o, d, key, depth=3))

    val, grads = jax.jit(jax.value_and_grad(loss))(scene.params)
    assert np.isfinite(float(val)) and float(val) > 0.01
    for leaf in jax.tree.leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()
    assert np.abs(np.asarray(grads["sphere_radius"])).max() > 0


def test_sweep_fixpoint_matches_sort_evt():
    """The sort-free fixpoint mode (the production default) must agree
    event-for-event with the sorted-sweep pipeline it replaces, on the
    adversarial coincident-boundary scene AND on compound gadgets with
    rays originating inside geometry (chains longer than one hop)."""
    from ptx.scenes.builders import (union_array, sky_planes,
                                     stress_gadgets, stress_spheres)
    from ptx.geom.tape import Sphere, Plane
    from ptx.shade.materials import Material

    m1 = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    m2 = Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    worlds = [
        union_array([
            Sphere((0.0, 0.0, -3.0), 1.0, m1),
            Sphere((0.0, 0.0, -3.0), 1.0, m2),   # identical — ties
            Sphere((0.5, 0.0, -3.5), 1.0, m2),   # overlapping chain
            Sphere((0.0, 0.0, -5.0), 1.0, m1),   # touching along the axis
            # a rod of overlapping spheres along -z: multi-hop chains for
            # rays inside it (the fixpoint's worst-case shape)
            *[Sphere((0.0, -0.5, -2.0 - 0.7 * i), 0.5, m1)
              for i in range(12)],
            Plane((0.0, 1.0, 0.0), 1.0, m1),
            *sky_planes(sky),
        ]),
        stress_spheres(57),
        stress_gadgets(9, seed=4),
    ]
    g = np.random.default_rng(11)
    for world in worlds:
        scene = compile_scene(world)
        fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
        srt = compile_fast_hit(scene.plan, sweep=True, sweep_mode="sort")
        o = np.concatenate([
            np.zeros((128, 3)),
            np.array([[0.0, -0.5, -4.0]] * 64),   # inside the rod
            g.uniform(-3, 3, (192, 3)),
        ]).astype(np.float32)
        d = np.concatenate([
            np.stack([g.uniform(-1, 1, 128), g.uniform(-1, 1, 128),
                      np.full(128, -1.0)], -1),
            np.array([[0.0, 0.0, -1.0]] * 32 + [[0.0, 0.0, 1.0]] * 32),
            g.normal(size=(192, 3)),
        ]).astype(np.float32)
        o, d = jnp.asarray(o), jnp.asarray(d)
        a = jax.jit(fix)(scene.params, o, d)
        b = jax.jit(srt)(scene.params, o, d)
        _assert_hits_match(a, b)
        np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                      np.asarray(b["_evt"]))


def _coincident_world(rod=False):
    """Exactly-coincident boundaries (identical spheres), an overlapping
    chain, spheres touching along the axis and, with ``rod``, a rod of
    overlapping spheres along −z (multi-hop chains for rays inside it)."""
    from ptx.scenes.builders import union_array, sky_planes
    from ptx.geom.tape import Sphere, Plane
    from ptx.shade.materials import Material

    m1 = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    m2 = Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    objs = [Sphere((0.0, 0.0, -3.0), 1.0, m1),
            Sphere((0.0, 0.0, -3.0), 1.0, m2),
            Sphere((0.5, 0.0, -3.5), 1.0, m2),
            Sphere((0.0, 0.0, -5.0), 1.0, m1)]
    if rod:
        objs += [Sphere((0.0, -0.5, -2.0 - 0.7 * i), 0.5, m1)
                 for i in range(12)]
    return union_array(objs + [Plane((0.0, 1.0, 0.0), 1.0, m1),
                               *sky_planes(sky)])


def _spans_hit(scene, o, d):
    return jax.jit(lambda p, o, d: first_hit(scene.spans_fn(p, o, d)))(
        scene.params, o, d)


def _assert_matches_oracle(got, want, min_agree=0.995):
    """Fixpoint sweep vs the span-merge reference.  Decisions must agree
    on all but measure-zero lanes (exact ties the two resolve
    differently: coincident spheres, grazing tangencies); payloads agree
    on every agreeing lane."""
    g = {k: np.asarray(v) for k, v in got.items()}
    w = {k: np.asarray(v) for k, v in want.items()}
    agree = g["hit"] == w["hit"]
    both = agree & g["hit"]
    agree[both] &= (g["mat_id"][both] == w["mat_id"][both]) | (
        np.abs(g["t"][both] - w["t"][both]) > 1e-5)
    assert agree.mean() >= min_agree, float(agree.mean())
    close = np.abs(g["t"][both] - w["t"][both]) <= 2e-5 * (
        1.0 + np.abs(w["t"][both]))
    assert close.mean() >= min_agree, float(close.mean())
    st = both & (np.abs(g["t"] - w["t"]) <= 2e-5 * (1.0 + np.abs(w["t"])))
    np.testing.assert_array_equal(g["entering"][st], w["entering"][st])
    np.testing.assert_allclose(g["normal"][st], w["normal"][st],
                               rtol=1e-4, atol=3e-4)


def test_union_sweep_matches_spans_oracle_random_rays():
    """Fixpoint sweep vs the span-merge reference on rays from anywhere
    in the scene, pointing anywhere (gadgets and spheres)."""
    world = stress_spheres(24)                      # L = 31, has gadgets
    scene = compile_scene(world)
    hit_fn = compile_fast_hit(scene.plan, sweep=True)
    g = np.random.default_rng(7)
    o = jnp.asarray(g.uniform(-4, 4, (512, 3)).astype(np.float32))
    d = jnp.asarray(g.normal(size=(512, 3)).astype(np.float32))
    got = jax.jit(hit_fn)(scene.params, o, d)
    assert int(np.asarray(got["hit"]).sum()) > 100
    _assert_matches_oracle(got, _spans_hit(scene, o, d))


def test_union_sweep_coincident_boundaries_match_dense_fold():
    """Identical, overlapping and touching spheres — where the span-merge
    reference's zero-length spans make it no oracle — the fixpoint sweep
    agrees event-for-event with the dense membership fold, whose
    tie-break order is the reference's (collect_leaves)."""
    scene = compile_scene(_coincident_world())
    fix = compile_fast_hit(scene.plan, sweep=True)
    dense = compile_fast_hit(scene.plan, candidate_block=0, sweep=False)
    g = np.random.default_rng(3)
    o = np.concatenate([np.zeros((128, 3)),
                        np.array([[0.0, 0.0, -3.0]] * 64),
                        g.uniform(-2, 2, (64, 3))]).astype(np.float32)
    d = np.concatenate([
        np.stack([g.uniform(-1, 1, 128), g.uniform(-1, 1, 128),
                  np.full(128, -1.0)], -1),
        np.array([[0.0, 0.0, -1.0]] * 64),
        g.normal(size=(64, 3)),
    ]).astype(np.float32)
    o, d = jnp.asarray(o), jnp.asarray(d)
    a = jax.jit(fix)(scene.params, o, d)
    b = jax.jit(dense)(scene.params, o, d)
    _assert_hits_match(a, b)
    np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                  np.asarray(b["_evt"]))


def _rod_rays(g):
    o = np.concatenate([
        np.zeros((128, 3)),
        np.array([[0.0, -0.5, -4.0]] * 64),   # inside the rod
        g.uniform(-3, 3, (192, 3)),
    ]).astype(np.float32)
    d = np.concatenate([
        np.stack([g.uniform(-1, 1, 128), g.uniform(-1, 1, 128),
                  np.full(128, -1.0)], -1),
        np.array([[0.0, 0.0, -1.0]] * 32 + [[0.0, 0.0, 1.0]] * 32),
        g.normal(size=(192, 3)),
    ]).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def test_fixpoint_rod_matches_dense_fold():
    """Multi-hop chains — rays inside a rod of overlapping spheres, the
    fixpoint's worst case — event-for-event against the dense fold."""
    scene = compile_scene(_coincident_world(rod=True))
    fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
    dense = compile_fast_hit(scene.plan, candidate_block=0, sweep=False)
    o, d = _rod_rays(np.random.default_rng(13))
    a = jax.jit(fix)(scene.params, o, d)
    b = jax.jit(dense)(scene.params, o, d)
    _assert_hits_match(a, b)
    np.testing.assert_array_equal(np.asarray(a["_evt"]),
                                  np.asarray(b["_evt"]))


def test_fixpoint_stress_grid_matches_spans_oracle():
    """The stress grid with rod-shaped ray sets: fixpoint sweep vs the
    span-merge reference."""
    scene = compile_scene(stress_spheres(41, seed=2))
    fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
    o, d = _rod_rays(np.random.default_rng(13))
    got = jax.jit(fix)(scene.params, o, d)
    _assert_matches_oracle(got, _spans_hit(scene, o, d))


def test_fixpoint_coherent_rays_and_gradients():
    """Coherent rays from above into one corner of the sphere grid agree
    with the span-merge reference, and d(Σ t)/d(sphere params) through
    the selected-leaf replay is finite and nonzero."""
    scene = compile_scene(stress_spheres(41, seed=5))
    fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
    g = np.random.default_rng(23)
    tgt = np.stack([g.uniform(-3.5, -2.0, 256), np.full(256, -0.8),
                    g.uniform(-4.0, -3.0, 256)], -1)
    o = np.tile(np.array([[-3.0, 4.0, 1.0]], np.float32), (256, 1))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    got = jax.jit(fix)(scene.params, o, d)
    assert int(np.asarray(got["hit"]).sum()) > 100
    _assert_matches_oracle(got, _spans_hit(scene, o, d))

    def loss(params):
        h = fix(params, o, d)
        return jnp.sum(jnp.where(h["hit"], h["t"], 0.0))

    grads = jax.jit(jax.grad(loss))(scene.params)
    for k in ("sphere_radius", "sphere_center"):
        gk = np.asarray(grads[k])
        assert np.isfinite(gk).all() and np.abs(gk).max() > 0, k


@pytest.mark.parametrize("n,seed", [(12, 0), (28, 4)])
def test_fixpoint_gadgets_match_spans_oracle(n, seed):
    """Compound gadgets (lenses, differences) through the group sweep's
    local membership folds + rank pairing vs the span-merge reference,
    including rays that start inside gadgets."""
    from ptx.scenes.builders import stress_gadgets

    scene = compile_scene(stress_gadgets(n, seed=seed))
    fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
    g = np.random.default_rng(1)
    B = 512
    o = np.concatenate([np.zeros((128, 3)),
                        g.uniform(-5, 5, (B - 128, 3))]).astype(np.float32)
    o[:, 1] = np.clip(o[:, 1], -0.9, 4)
    d = g.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    got = jax.jit(fix)(scene.params, oj, dj)
    _assert_matches_oracle(got, _spans_hit(scene, oj, dj))


@pytest.mark.parametrize("world_name", ["ellipsoids", "lens_gadgets"])
def test_fixpoint_transformed_matches_spans_oracle(world_name):
    """Transformed leaves on the fixpoint sweep: (a) a stress grid of
    per-sphere-rotated ellipsoids and (b) whole-gadget transforms (lenses
    rotated as a unit) agree with the span-merge reference, and gradients
    reach the XFORM parameters."""
    from ptx.core import linalg
    from ptx.geom.tape import Plane, Transformed, Union
    from ptx.scenes.builders import make_lens, sky_planes
    from ptx.shade.materials import Material

    g = np.random.default_rng(31)
    if world_name == "ellipsoids":
        world = stress_spheres(16, seed=7, transformed=True)
    else:
        glass = Material(reflect=0.7, scatter=0.0, transmit=0.9, ior=1.3,
                         transmit_reflect=1.0)
        sky = Material(reflect=0.0, scatter=0.0, emissive=(1.0, 1.0, 1.0))
        gads = []
        for _ in range(6):
            c = np.asarray((g.uniform(-3, 3), 0.0, g.uniform(-7, -3)),
                           np.float32)
            lens = make_lens(c, (0.0, 0.3, 1.0), 0.35, 0.7, glass)
            T = np.asarray(linalg.compose(
                linalg.translate(c),
                linalg.compose(linalg.rotate_z(g.uniform(0, 2)),
                               linalg.translate(-c))))
            gads.append(Transformed(lens, T))
        world = Union(*gads, Plane((0.0, 1.0, 0.0), 1.0, glass),
                      *sky_planes(sky))
    scene = compile_scene(world)
    assert any(lf.xform_chain for lf, _ in collect_leaves(scene.plan))
    fix = compile_fast_hit(scene.plan, sweep=True, sweep_mode="fixpoint")
    o = np.stack([g.uniform(-6, 6, 384), g.uniform(-1.5, 3, 384),
                  g.uniform(-9, 2, 384)], -1).astype(np.float32)
    d = g.normal(size=(384, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    got = jax.jit(fix)(scene.params, o, d)
    assert int(np.asarray(got["hit"]).sum()) > 100
    _assert_matches_oracle(got, _spans_hit(scene, o, d))

    def loss(params):
        h = fix(params, o, d)
        return jnp.sum(jnp.where(h["hit"], h["t"], 0.0))

    gx = np.asarray(jax.jit(jax.grad(loss))(scene.params)["xform"])
    assert np.isfinite(gx).all() and np.abs(gx).max() > 0, \
        "no gradient reached the transform parameters"
