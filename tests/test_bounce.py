"""The live bounce, its custom VJP and the decision-frozen replay.

- Two live bounces composed by hand on the production hit path (dense
  fold for the demo, union sweep for the stress scenes) agree with the
  same composition over the span-merge reference (``compile_scene(...,
  fast=False)``): same carry, same decisions on all but measure-zero
  lanes.
- The manual custom-VJP bounce step matches plain autodiff through the
  live bounce.
- The replay backward (``jax.vjp`` of ``_bounce_replay``) matches
  autodiff of the forward it replays, and stays finite on the exact
  filler-lane shape compaction constructs.
"""

import functools

import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp
import pytest

from ptx.core import rng as prng
from ptx.integrate import trace as tr
from ptx.scenes.builders import make_world, stress_gadgets, stress_spheres

stress_spheres_xf = functools.partial(stress_spheres, transformed=True)

_DKEYS = ("entering", "hit", "mat_id", "take_transmit", "scatter_alive")


def _rays(B, seed=0):
    """Half random spread, half AIMED at the stress scenes' object band
    (y ≈ -0.6, x ∈ ±3, z ∈ [-9, -3]) so the glass gadgets' transmit
    branch is exercised."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 3, B),
                  np.full(B, 12.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.4, 0.4, B), rng.uniform(-0.4, 0.4, B),
                  -np.ones(B)], -1).astype(np.float32)
    h = B // 2
    tgt = np.stack([rng.uniform(-3, 3, h), rng.uniform(-1.0, -0.3, h),
                    rng.uniform(-9, -3, h)], -1).astype(np.float32)
    aim = tgt - o[:h]
    d[:h] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _demo_rays(B, seed=0):
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(-0.6, 0.6, B),
                  -np.ones(B)], -1).astype(np.float32)
    return jnp.zeros((B, 3), jnp.float32), jnp.asarray(d)


def _chain(scene, o, d, keys):
    B = o.shape[0]
    carry = (o, d, jnp.ones((B, 3)), jnp.ones(B), jnp.ones(B, bool))

    @jax.jit
    def two(params, carry):
        decs = []
        for k in keys:
            carry, dec = tr._bounce_live(scene, params, *carry, k, True)
            decs.append({n: dec[n] for n in _DKEYS + ("t", "u_sel")})
        return carry, decs

    return two(scene.params, carry)


@pytest.mark.parametrize("builder,n", [(make_world, None),
                                       (stress_spheres, 25),
                                       (stress_gadgets, 12),
                                       (stress_spheres_xf, 25)])
def test_two_bounces_match_spans_oracle(builder, n):
    world = builder() if n is None else builder(n)
    scene = tr.compile_scene(world)
    oracle = tr.compile_scene(world, fast=False)
    B = 512
    o, d = _demo_rays(B, 3) if n is None else _rays(B, seed=1)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(21)]
    cf, df = _chain(scene, o, d, keys)
    cs, ds = _chain(oracle, o, d, keys)
    if builder is stress_gadgets:
        # the refract/transmit branch must actually be exercised
        assert int(np.asarray(ds[0]["take_transmit"]).sum()) >= 8

    # bounce 1: identical inputs ⇒ identical decisions but for
    # measure-zero ties, ulp-tight payloads
    agree = np.ones(B, bool)
    for k in _DKEYS:
        agree &= np.asarray(df[0][k]) == np.asarray(ds[0][k])
    assert agree.mean() >= 0.995, float(agree.mean())
    ta, tb = np.asarray(df[0]["t"])[agree], np.asarray(ds[0]["t"])[agree]
    assert (np.abs(ta - tb) > 1e-4 * np.abs(tb) + 5e-5).mean() < 0.01

    # bounce 2 inherits one-ulp carry differences; grazing lanes may
    # legitimately pick another leaf, so gate the flip fraction and the
    # agreement of everything else
    agree2 = agree.copy()
    for k in _DKEYS:
        agree2 &= np.asarray(df[1][k]) == np.asarray(ds[1][k])
    assert agree2.mean() >= 0.97, float(agree2.mean())

    def frac_bad(a, b):
        a, b = np.asarray(a)[agree2], np.asarray(b)[agree2]
        return float((np.abs(a - b) > 5e-3 * np.abs(b) + 5e-4).mean())

    for name, a, b in zip(("o2", "d2", "thr2", "strength2", "alive2"),
                          cf, cs):
        if np.asarray(a).dtype == bool:
            assert (np.asarray(a)[agree2] == np.asarray(b)[agree2]).all()
        else:
            assert frac_bad(a, b) < 0.02, name


@pytest.mark.parametrize("builder,n", [(make_world, None),
                                       (stress_gadgets, 12)])
def test_manual_vjp_bounce_matches_autodiff(builder, n):
    """One custom-VJP bounce step (live forward, decision-frozen replay
    backward) vs plain autodiff through the live bounce, on a loss that
    touches the emission inputs and the differentiable continuation."""
    scene = tr.compile_scene(builder() if n is None else builder(n))
    B = 128
    o, d = _demo_rays(B, seed=5) if n is None else _rays(B, seed=5)
    k = jax.random.PRNGKey(2)
    thr0, st0, al0 = jnp.ones((B, 3)), jnp.ones(B), jnp.ones(B, bool)
    w = jnp.array([0.3, 1.1, 0.6])
    bs = tr._make_manual_bounce(scene)
    u_coin = jax.random.uniform(prng.fold(k, 1), (B,))
    u3 = jax.random.uniform(prng.fold(k, 2), (B, 3))

    def em_term(params, pos, mid, live, thr):
        em = scene.material_fn.eval_emissive(params, pos, mid)
        return jnp.sum(jnp.where(live[..., None], thr * em, 0.0) * w)

    def loss_manual(params):
        # ys is the packed (B, 8) per-bounce emission row: pos | thr |
        # mat_id | live
        (o2, d2, thr2, st2, al2), ys = bs(params, o, d, thr0, st0, al0,
                                          k, True, u_coin, u3)
        pos = jax.lax.stop_gradient(ys[:, 0:3])
        mid = jax.lax.stop_gradient(ys[:, 6]).astype(jnp.int32)
        return (em_term(params, pos, mid, ys[:, 7] > 0.5, ys[:, 3:6])
                + 1e-3 * jnp.sum(thr2) + 1e-4 * jnp.sum(d2 * d2))

    def loss_auto(params):
        (o2, d2, thr2, st2, al2), dec = tr._bounce_live(
            scene, params, o, d, thr0, st0, al0, k, True,
            u_coin=u_coin, u3=u3)
        pos = jax.lax.stop_gradient(o + dec["t"][..., None] * d)
        return (em_term(params, pos, dec["mat_id"], al0 & dec["hit"], thr0)
                + 1e-3 * jnp.sum(thr2) + 1e-4 * jnp.sum(d2 * d2))

    gm = jax.jit(jax.grad(loss_manual))(scene.params)
    ga = jax.jit(jax.grad(loss_auto))(scene.params)
    flat_m, _ = jax.flatten_util.ravel_pytree(
        {k_: v for k_, v in gm.items() if k_ != "images"})
    flat_a, _ = jax.flatten_util.ravel_pytree(
        {k_: v for k_, v in ga.items() if k_ != "images"})
    assert np.abs(np.asarray(flat_a)).max() > 0
    denom = np.maximum(np.abs(np.asarray(flat_a)), 1e-3)
    rel = np.abs(np.asarray(flat_m) - np.asarray(flat_a)) / denom
    assert np.quantile(rel, 0.99) < 5e-3, float(np.quantile(rel, 0.99))
    for a, b in zip(jax.tree.leaves(gm["images"]),
                    jax.tree.leaves(ga["images"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def _q(a, b, q):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-3)
    return float(np.quantile(rel, q))


@pytest.mark.parametrize("builder,n", [(stress_spheres, 25),
                                       (stress_gadgets, 12)])
def test_replay_bwd_matches_autodiff_of_forward(builder, n):
    """The replay backward (the large-scene reverse pass) vs autodiff of
    the live forward bounce it replays, for carry and parameter
    cotangents."""
    scene = tr.compile_scene(builder(n))
    B = 512
    o, d = _rays(B, seed=3)
    thr = jnp.full((B, 3), 0.8)
    st = jnp.ones(B)
    alive = jnp.ones(B, bool)
    k = jax.random.PRNGKey(9)
    u_coin = jax.random.uniform(prng.fold(k, 1), (B,))
    u3 = jax.random.uniform(prng.fold(k, 2), (B, 3))
    _, dec = jax.jit(lambda p: tr._bounce_live(
        scene, p, o, d, thr, st, alive, k, True, u_coin=u_coin,
        u3=u3))(scene.params)
    assert bool(np.asarray(dec["hit"]).any()), "degenerate fixture"

    rng = np.random.default_rng(11)
    cts = tuple(jnp.asarray(rng.normal(size=(B, 3)).astype(np.float32))
                for _ in range(3)) + (jnp.zeros(B),)

    @jax.jit
    def replay_vjp(params):
        def rep(params, o_, d_, thr_, st_):
            return tr._bounce_replay(scene, params, o_, d_, thr_, st_,
                                     alive, dec)
        _, vjp = jax.vjp(rep, params, o, d, thr, st)
        return vjp(cts)

    @jax.jit
    def forward_vjp(params):
        def live(params, o_, d_, thr_, st_):
            return tr._bounce_live(scene, params, o_, d_, thr_, st_, alive,
                                   k, True, u_coin=u_coin, u3=u3)[0][:4]
        _, vjp = jax.vjp(live, params, o, d, thr, st)
        return vjp(cts)

    rp, ro, rd, rthr, _ = replay_vjp(scene.params)
    fp, fo, fd, fthr, _ = forward_vjp(scene.params)
    # grazing lanes (the aimed rays guarantee some) have near-singular
    # jacobians (d t/d params → ∞ at tangency): the bulk must be sharp,
    # the tail only close
    for a, b in ((ro, fo), (rd, fd), (rthr, fthr)):
        assert np.isfinite(np.asarray(a)).all()
        assert _q(a, b, 0.75) < 1e-3 and _q(a, b, 0.99) < 2e-2
    flat_r, _ = jax.flatten_util.ravel_pytree(
        {n_: v for n_, v in rp.items() if n_ != "images"})
    flat_f, _ = jax.flatten_util.ravel_pytree(
        {n_: v for n_, v in fp.items() if n_ != "images"})
    assert np.isfinite(np.asarray(flat_r)).all()
    assert np.abs(np.asarray(flat_f)).max() > 0
    assert _q(flat_r, flat_f, 0.75) < 1e-3 and _q(flat_r, flat_f, 0.99) < 0.1


def test_replay_grazing_filler_lane_gradient_finite():
    """eta = 1 with d ⊥ n gives the refraction discriminant ≡ 0 EXACTLY,
    and sqrt'(0) = inf would NaN d(ior) even under zero cotangents
    (0·inf).  Compaction filler lanes construct this exact lane: a MISS
    (hit=False ⇒ the replay's unit placeholder normal) with d ⊥ that
    normal, entering=False ⇒ rel_ior = ior = 1."""
    from ptx.geom.tape import Sphere
    from ptx.scenes.builders import sky_planes, union_array
    from ptx.shade.materials import Material

    glass1 = Material(reflect=0.5, scatter=0.0, transmit=0.9, ior=1.0,
                      transmit_reflect=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(1.0, 1.0, 1.0))
    from ptx.shade.materials import assign_material_ids
    world = union_array([Sphere((0.0, 0.0, -4.0), 1.0, glass1)]
                        + sky_planes(sky))
    scene = tr.compile_scene(world)
    _, ids = assign_material_ids(world)
    B = 4
    f = jnp.zeros(B, bool)
    t = jnp.ones(B, bool)
    dec = {"evt": jnp.zeros(B, jnp.int32), "hit": f, "entering": f,
           "mat_id": jnp.full(B, ids[id(glass1)], jnp.int32),
           "take_transmit": t, "scatter_alive": f,
           "u_sel": jnp.tile(jnp.array([[0.1, 0.2, 0.3]]), (B, 1)),
           "t": jnp.zeros(B)}
    o = jnp.zeros((B, 3))
    normal = scene.hit_replay_fn(scene.params, o, jnp.ones((B, 3)),
                                 dec["evt"], dec["entering"], dec["hit"])[1]
    n0 = np.asarray(normal)[0]
    # a unit direction exactly perpendicular to the placeholder normal
    perp = np.cross(n0, [1.0, 0.0, 0.0] if abs(n0[0]) < 0.9
                    else [0.0, 1.0, 0.0])
    d = jnp.tile(jnp.asarray(perp / np.linalg.norm(perp), jnp.float32),
                 (B, 1))

    def f_loss(params):
        out = tr._bounce_replay(scene, params, o, d, jnp.ones((B, 3)),
                                jnp.ones(B), jnp.ones(B, bool), dec)
        # RUNTIME-zero cotangents (a trace-time 0.0 weight gets pruned
        # before the transpose ever evaluates the 0·inf product)
        w0 = jnp.where(jnp.ones(B) > 0.0, 0.0, 1.0)
        return sum(jnp.sum(v * (w0[:, None] if v.ndim == 2 else w0))
                   for v in out)

    g = jax.grad(f_loss)(scene.params)
    assert np.isfinite(np.asarray(g["ior"])).all(), "0*inf NaN via sqrt(0)"
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
