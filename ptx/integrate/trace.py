"""The integrator: scene compilation + the wavefront bounce loop.

The reference's ``traceRay`` (``/root/reference/include/path-trace.h:59-165``)
is a per-ray recursion: walk the span stream for the first boundary past
``eps``, add emission, then recurse into a transmission branch *and* a
scatter branch (the scatter branch fanning out into
``scatter_ray_count = int(10000·strength·addFactor·scatter)`` children).

Array-first re-conception
-------------------------
Recursion and branching become a masked ``lax.scan`` over bounces carrying
a wavefront of rays ``(origin, dir, throughput, strength, alive)``.  At
each hit exactly **one** continuation is sampled:

- transmit with probability ``p = refract_factor`` (the reference's branch
  weight), scaled by ``transmit / p · refract_factor = transmit``;
- otherwise scatter, whose reference weight ``addFactor·factor·reflect``
  divided by the selection probability ``addFactor`` leaves
  ``factor·reflect``.

This one-sample estimator has the same expectation as the reference's
branching recursion; the reference's adaptive ``scatter_ray_count`` fan-out
is itself only a variance-control knob, recovered here by raising
samples-per-pixel (uniform work is what the hardware wants).  The
``strength`` value threads through exactly as in the reference — it is a
*termination heuristic*, not part of the estimator — so path lengths match.

Gradients: boundary/branch *selection* is piecewise-constant (wrapped in
``stop_gradient``); everything gathered through the selection — hit
distances, normals, texture lookups, Fresnel weights — stays
differentiable w.r.t. scene parameters, which is what the BASELINE
pixel-gradient metric differentiates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp

from ptx.core import linalg, rng
from ptx.core.constants import DEFAULT_RAY_DEPTH, EPS, MAX_VALUE
from ptx.geom import tape
from ptx.shade import materials as mats
from ptx.shade import textures as tx

# Tries for the batched-rejection scatter sampler
# (sample_scatter_dir_rejection — the cross-check oracle; production uses
# the exact zero-rejection cap sampler, sample_scatter_dir).  The
# reference resamples up to 1000 times and abandons the path beyond that
# (path-trace.h:144-152); joint cube∧hemisphere acceptance is ≥ ~0.27 per
# try, so 32 tries leave a ≤5e-5 abandonment probability.
SCATTER_TRIES = 32


@dataclasses.dataclass(eq=False)
class CompiledScene:
    """A scene lowered to arrays + pure functions.

    ``params`` is the differentiable pytree: geometry leaves, transform
    matrices, texture constants/factors/matrices/images, per-material ior.

    Two equivalent geometry paths exist: ``hit_fn`` (the production
    single-sort direct first-hit, ptx.geom.fasthit) and ``spans_fn`` +
    :func:`first_hit` (the span-merge reference path, kept for span-level
    consumers and as a cross-check oracle).

    ``eq=False`` keeps identity ``__eq__``/``__hash__`` so instances can be
    jit static args (render/adaptive pass the scene statically).
    """
    params: dict
    spans_fn: Callable          # (params, origin, dir) -> SpanList
    material_fn: Callable       # (params, pos, mat_id) -> slot dict
    n_materials: int
    plan: Any = None
    hit_fn: Callable = None     # (params, origin, dir) -> first-hit dict
    hit_replay_fn: Callable = None   # (params, o, d, evt, entering, hit)
    _manual_bounce: Callable = None  # cached custom-VJP bounce step


def compile_scene(root, fast: bool = True) -> CompiledScene:
    """Compile a scene tree.

    ``fast`` selects the direct first-hit path (ptx.geom.fasthit); with
    ``fast=False`` the integrator walks the span-merge reference instead.

    Building runs on the host CPU (ptx.utils.device); the params then
    move to the default device as uncommitted arrays: the first jitted
    call uses them in place, and ``shard_map`` replicates them over a
    mesh.
    """
    from ptx.geom import hitreplay
    from ptx.geom.fasthit import collect_leaves, compile_fast_hit
    from ptx.utils.device import host_default_device

    with host_default_device():
        ordered_materials, mat_ids = mats.assign_material_ids(root)
        geo_params, spans_fn, plan = tape.compile_geometry(root, mat_ids)
        compiler = tx.TextureCompiler()
        mat_params, material_fn = mats.compile_material_table(
            ordered_materials, compiler)
        params = dict(geo_params)
        params.update(mat_params)
        params.update(compiler.finalize())

        hit_fn = hit_replay_fn = None
        if fast:
            hit_fn = compile_fast_hit(plan)
            hit_replay_fn = hitreplay.build_hit_replay(collect_leaves(plan))
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), params)
    return CompiledScene(params=params, spans_fn=spans_fn,
                         material_fn=material_fn,
                         n_materials=len(ordered_materials), plan=plan,
                         hit_fn=hit_fn, hit_replay_fn=hit_replay_fn)


# ---------------------------------------------------------------------------
# first hit
# ---------------------------------------------------------------------------

def first_hit(sl):
    """Resolve the span walk of path-trace.h:66-99 in one vectorized pass.

    Per span, in list order, the reference returns on the first of:
      1. ``t0 >= MAX_VALUE``   → escaped (black)
      2. ``t0 >= EPS``         → hit entry boundary (normal, 1/ior)
      3. ``t1 >= MAX_VALUE``   → escaped
      4. ``t1 >= EPS``         → hit exit boundary (−normal, ior)
    No span triggering ⇒ miss.
    Returns dict of (t, normal, mat_id, entering, hit) — ``hit`` False for
    both miss and escape.
    """
    c1 = sl.t0 >= MAX_VALUE
    c2 = sl.t0 >= EPS
    c3 = sl.t1 >= MAX_VALUE
    c4 = sl.t1 >= EPS
    trigger = sl.valid & (c1 | c2 | c3 | c4)
    any_trigger = jnp.any(trigger, axis=-1)
    idx = jnp.argmax(trigger, axis=-1)            # first triggering span
    idx = jax.lax.stop_gradient(idx)

    take = lambda a: jnp.take_along_axis(a, idx[..., None], axis=-1)[..., 0]
    take3 = lambda a: jnp.take_along_axis(a, idx[..., None, None], axis=-2)[..., 0, :]
    s_c1, s_c2, s_c3 = take(c1), take(c2), take(c3)
    escaped = s_c1 | (~s_c2 & s_c3)
    entering = ~s_c1 & s_c2

    t = jnp.where(entering, take(sl.t0), take(sl.t1))
    normal = jnp.where(entering[..., None], take3(sl.n0), -take3(sl.n1))
    mat_id = jnp.where(entering, take(sl.m0), take(sl.m1))
    hit = any_trigger & ~escaped
    return {
        "t": jnp.where(hit, t, 0.0),
        "normal": normal,
        "mat_id": jax.lax.stop_gradient(jnp.where(hit, mat_id, 0)),
        "entering": entering,
        "hit": hit,
    }


# ---------------------------------------------------------------------------
# scatter direction sampling
# ---------------------------------------------------------------------------

def sample_scatter_dir(key, direction, normal, scatter_c, return_raw=False,
                       u3=None):
    """Exact (zero-rejection) reference scatter sampling.

    The reference draws uniform points in the unit ball, adds
    ``bias = (1/sc − 1)·reflected``, and rejects until the result leaves
    the surface (``dot(n, u + bias) > EPS``; path-trace.h:138-158,
    vector3d.h:163-185).  The accepted ``u`` is therefore *uniform over
    the ball cap* ``{|u| ≤ 1, n̂·u > c}`` with ``c = (EPS − n·bias)/|n|``
    — which this sampler draws directly, with THREE uniforms per lane
    instead of the rejection loop's ≈96 (the (B, 32, 3) candidate draws
    dominate the rejection sampler's cost):

    - height ``z ∈ [c, 1]`` with density ∝ (1 − z²) (the disk area at
      height z).  The CDF ``g(z) = z − z³/3`` inverts in closed form via
      the trigonometric cubic root ``z = 2·cos(acos(−1.5·G)/3 − 2π/3)``;
    - a uniform point on the radius-``√(1−z²)`` disk (angle + √radius);
    - mapped through a branchless orthonormal frame around ``n̂``
      (Duff et al. 2017, "Building an Orthonormal Basis, Revisited").

    Distribution-identical to :func:`sample_scatter_dir_rejection`
    (asserted statistically in tests/test_integrator.py); abandonment
    (``ok`` False) now happens exactly when the cap is empty — the ideal
    limit of the reference's 1000-try bailout.  For ``sc <= EPS`` the
    perfect mirror direction is used directly.

    ``return_raw`` appends the in-ball draw ``u`` (..., 3) — the manual
    bounce VJP saves it so the backward replay reconstructs
    ``normalize(u + bias)`` differentiably (:func:`_bounce_replay`).
    """
    reflected = linalg.reflect(direction, normal)
    sc = jnp.clip(scatter_c, 0.0, 1.0)
    specular = sc <= EPS
    safe_sc = jnp.where(specular, 1.0, sc)
    bias = (1.0 / safe_sc - 1.0)[..., None] * reflected

    # acceptance threshold in the unit-normal frame (normals arrive unit
    # from the hit paths; |n| guarded for dead lanes)
    m2 = jnp.sum(normal * normal, axis=-1)
    m = jnp.sqrt(jnp.where(m2 == 0.0, 1.0, m2))
    nhat = normal / m[..., None]
    c = (EPS - jnp.einsum("...i,...i->...", normal, bias,
                          precision=jax.lax.Precision.HIGHEST)) / m
    feasible = c < 1.0
    cc = jnp.clip(c, -1.0, 1.0)

    if u3 is None:
        u3 = jax.random.uniform(key, direction.shape[:-1] + (3,))
    g = lambda z: z - z * z * z * (1.0 / 3.0)
    G = g(cc) + u3[..., 0] * (g(1.0) - g(cc))
    arg = jnp.clip(-1.5 * G, -1.0, 1.0)
    z = 2.0 * jnp.cos(jnp.arccos(arg) * (1.0 / 3.0) - 2.0 * jnp.pi / 3.0)
    z = jnp.clip(z, cc, 1.0)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0) * u3[..., 1])
    phi = (2.0 * jnp.pi) * u3[..., 2]
    x, y = r * jnp.cos(phi), r * jnp.sin(phi)

    nx, ny, nz = nhat[..., 0], nhat[..., 1], nhat[..., 2]
    s = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    e1 = jnp.stack([1.0 + s * nx * nx * a, s * b, -s * nx], axis=-1)
    e2 = jnp.stack([b, s + ny * ny * a, -ny], axis=-1)
    u = jax.lax.stop_gradient(
        x[..., None] * e1 + y[..., None] * e2 + z[..., None] * nhat)

    out = jnp.where(specular[..., None], reflected,
                    linalg.normalize(u + bias))
    ok = specular | jax.lax.stop_gradient(feasible)
    if return_raw:
        return out, ok, u
    return out, ok


def sample_scatter_dir_rejection(key, direction, normal, scatter_c,
                                 return_raw=False):
    """The batched-rejection form of the scatter sampler (kept as the
    cross-check oracle for the exact sampler and
    for the stream-matched LCG parity path): one (..., T, 3) cube draw,
    first candidate satisfying (in-ball ∧ above-surface) wins — see
    :func:`select_scatter_dir`.

    Returns (dir, ok): ``ok`` False for abandoned paths (reference's
    1000-try bailout; ≤5e-5 here with T=32 — joint acceptance ≥ ~0.27).
    """
    u = jax.random.uniform(key, direction.shape[:-1] + (SCATTER_TRIES, 3),
                           minval=-1.0, maxval=1.0)
    return select_scatter_dir(u, direction, normal, scatter_c,
                              return_raw=return_raw)


def select_scatter_dir(u, direction, normal, scatter_c, return_raw=False):
    """The selection half of the reference scatter sampler, driven by a
    pre-drawn candidate array ``u`` (..., T, 3) of cube uniforms.

    The reference consumes ONE cube-draw stream: its inner do-while
    (vector3d.h:173-180) skips draws outside the unit ball, its outer
    do-while (path-trace.h:145-157) skips in-ball draws that fail the
    above-surface test — so its accepted sample is exactly the FIRST draw
    satisfying (in-ball ∧ above), which is this argmax.  Validated
    draw-for-draw against a scalar transcription on ReferenceLCG streams
    in tests/test_rng.py."""
    reflected = linalg.reflect(direction, normal)
    sc = jnp.clip(scatter_c, 0.0, 1.0)
    specular = sc <= EPS
    safe_sc = jnp.where(specular, 1.0, sc)
    bias = (1.0 / safe_sc - 1.0)[..., None] * reflected

    in_ball = jnp.sum(u * u, axis=-1) <= 1.0          # cube→ball rejection
    cand = u + bias[..., None, :]
    above = jnp.einsum("...i,...ti->...t", normal, cand,
                       precision=jax.lax.Precision.HIGHEST) > EPS
    ok_t = in_ball & above
    accepted = jnp.any(ok_t, axis=-1)
    first = jnp.argmax(ok_t, axis=-1)
    first = jax.lax.stop_gradient(first)
    chosen = jnp.take_along_axis(cand, first[..., None, None],
                                 axis=-2)[..., 0, :]
    accepted = jax.lax.stop_gradient(accepted)

    out = jnp.where(specular[..., None], reflected, linalg.normalize(chosen))
    ok = specular | accepted
    if return_raw:
        u_raw = jnp.take_along_axis(u, first[..., None, None],
                                    axis=-2)[..., 0, :]
        return out, ok, u_raw
    return out, ok


# ---------------------------------------------------------------------------
# bounce scan
# ---------------------------------------------------------------------------

def _virtual_fanout(strength, add_factor, sc):
    """The scatter-child count the reference would have spawned at this
    hit: ``int(10000·strength·addFactor·sc)``, clamped to ≥ 1 (and to 1
    for specular), path-trace.h:130-136.  The reference divides each
    child's *strength* by this count, so after one full-diffuse bounce
    from a camera ray (count ≈ 10⁴) children fall below the ``eps``
    termination threshold and stop at their next hit.  The single-path
    estimator must inherit that termination rule — without the division
    ptx's diffuse chains keep bouncing and come out measurably brighter
    (+15% median on the diffuse-sphere parity block, BASELINE.md)."""
    vcount = jnp.floor(10000.0 * strength * add_factor * sc)
    return jnp.where((sc <= EPS) | (vcount < 1.0), 1.0, vcount)


def _bounce_live(scene: CompiledScene, params, o, d, throughput, strength,
                 alive, k, in_depth, u_coin=None, u3=None):
    """One wavefront bounce, live mode: draws RNG, evaluates the first hit,
    makes the stochastic/discrete decisions.

    Returns ``(new_carry, decisions)``; decisions are everything the
    backward replay needs that is either random (branch coin, selected
    scatter draw) or expensive to recompute (the winning hit event) — all
    stop-gradient by construction.  Radiance is NOT accumulated here:
    emission never feeds the continuation, so trace_rays evaluates it
    post-scan for a whole phase at once (one batched texture evaluation
    per phase instead of one per bounce).

    ``u_coin``/``u3``: optional precomputed uniforms (the same threefry
    draws this function would make itself from ``k`` — trace_rays batches
    them across bounces before the scan).
    """
    batch_shape = o.shape[:-1]

    if scene.hit_fn is not None:
        hit = scene.hit_fn(params, o, d)
    else:
        hit = first_hit(scene.spans_fn(params, o, d))
    live_hit = alive & hit["hit"]

    pos = o + hit["t"][..., None] * d
    m = scene.material_fn(params, pos, hit["mat_id"])

    # Continuation gate: depth remaining and strength above threshold
    # (path-trace.h:105).  The final scan step (in_depth False) is the
    # emission-only evaluation.
    cont = live_hit & in_depth & (strength >= EPS)

    normal = hit["normal"]
    rel_ior = jnp.where(hit["entering"], 1.0 / m["ior"], m["ior"])

    trc = jnp.clip(m["transmit_reflect_f"], 0.0, 1.0)
    refract_factor = trc * linalg.refract_strength(d, rel_ior, normal)
    refr_dir = linalg.refract(d, rel_ior, normal)
    refr_ok = (refract_factor > EPS) & jnp.any(refr_dir != 0.0, axis=-1)
    p_transmit = jnp.where(refr_ok, refract_factor, 0.0)

    u = (u_coin if u_coin is not None
         else jax.random.uniform(rng.fold(k, 1), batch_shape))
    take_transmit = jax.lax.stop_gradient(u < p_transmit) & cont
    add_factor = 1.0 - p_transmit
    # reference: if addFactor < eps the scatter branch is skipped
    # (path-trace.h:122-125)
    scatter_alive = cont & ~take_transmit & (add_factor >= EPS)

    # --- transmit branch ---
    transmit_tint = m["transmit"]
    # --- scatter branch ---
    scat_dir, scat_ok, u_sel = sample_scatter_dir(
        rng.fold(k, 2), d, normal, m["scatter_f"], return_raw=True, u3=u3)
    sc = jnp.clip(m["scatter_f"], 0.0, 1.0)
    factor = 1.0 - (1.0 - linalg.dot(scat_dir, normal)) * sc
    scatter_alive = scatter_alive & scat_ok

    new_alive = take_transmit | scatter_alive
    new_dir = jnp.where(take_transmit[..., None], refr_dir, scat_dir)
    branch_tint = jnp.where(take_transmit[..., None], transmit_tint,
                            factor[..., None] * m["reflect"])
    new_throughput = throughput * branch_tint

    # Reference strength bookkeeping (path-trace.h:118,162) — the
    # termination heuristic, deliberately NOT importance-compensated.  It
    # is consumed ONLY by comparisons (the cont gate), so its gradient
    # contribution is identically zero: stop_gradient both documents that
    # and prunes the whole chain from the backward graph.
    tr_strength = strength * refract_factor * linalg.norm(transmit_tint)
    sc_strength = (strength / _virtual_fanout(strength, add_factor, sc)
                   * add_factor * factor * linalg.norm(m["reflect"]))
    new_strength = jnp.where(take_transmit, tr_strength, sc_strength)

    o2 = jnp.where(new_alive[..., None], pos, o)
    d2 = jnp.where(new_alive[..., None], new_dir, d)
    throughput2 = jnp.where(new_alive[..., None], new_throughput, throughput)
    strength2 = jax.lax.stop_gradient(
        jnp.where(new_alive, new_strength, strength))

    sg = jax.lax.stop_gradient
    decisions = {
        "evt": sg(hit["_evt"]) if "_evt" in hit else None,
        "hit": sg(hit["hit"]),
        "entering": sg(hit["entering"]),
        "mat_id": sg(hit["mat_id"]),
        "take_transmit": sg(take_transmit),
        "scatter_alive": sg(scatter_alive),
        "u_sel": sg(u_sel),
        # the post-scan emissive eval point: pos = o + t·d with a FROZEN
        # t (d emissive/d pos ≡ 0 through nearest-texel gathers, so
        # freezing is exact)
        "t": sg(hit["t"]),
    }
    return (o2, d2, throughput2, strength2, new_alive), decisions


def _bounce_replay(scene: CompiledScene, params, o, d, throughput, strength,
                   alive, dec):
    """Differentiable bounce replay: identical math to :func:`_bounce_live`
    with every stochastic draw and discrete selection taken from ``dec``.
    The first hit collapses to the O(1) selected-boundary recompute
    (ptx.geom.hitreplay) — no 2L·L candidate fold in the backward graph.
    Emission is not replayed (radiance lives post-scan in trace_rays and
    is differentiated by plain autodiff there).

    Returns ``(o2, d2, throughput2, strength2)``; the caller pulls
    cotangents through this with ``jax.vjp``.
    """
    t, normal = scene.hit_replay_fn(params, o, d, dec["evt"],
                                    dec["entering"], dec["hit"])
    live_hit = alive & dec["hit"]

    pos = o + t[..., None] * d
    m = scene.material_fn(params, pos, dec["mat_id"])

    rel_ior = jnp.where(dec["entering"], 1.0 / m["ior"], m["ior"])
    trc = jnp.clip(m["transmit_reflect_f"], 0.0, 1.0)
    refract_factor = trc * linalg.refract_strength(d, rel_ior, normal)
    refr_dir = linalg.refract(d, rel_ior, normal)
    refr_ok = (refract_factor > EPS) & jnp.any(refr_dir != 0.0, axis=-1)
    p_transmit = jnp.where(refr_ok, refract_factor, 0.0)
    take_transmit = dec["take_transmit"]
    add_factor = 1.0 - p_transmit

    transmit_tint = m["transmit"]
    # scatter direction from the SAVED accepted draw — no 32-candidate
    # rejection scan in the backward graph (see sample_scatter_dir)
    reflected = linalg.reflect(d, normal)
    sc = jnp.clip(m["scatter_f"], 0.0, 1.0)
    specular = sc <= EPS
    safe_sc = jnp.where(specular, 1.0, sc)
    bias = (1.0 / safe_sc - 1.0)[..., None] * reflected
    scat_dir = jnp.where(specular[..., None], reflected,
                         linalg.normalize(dec["u_sel"] + bias))
    factor = 1.0 - (1.0 - linalg.dot(scat_dir, normal)) * sc
    scatter_alive = dec["scatter_alive"]

    new_alive = take_transmit | scatter_alive
    new_dir = jnp.where(take_transmit[..., None], refr_dir, scat_dir)
    branch_tint = jnp.where(take_transmit[..., None], transmit_tint,
                            factor[..., None] * m["reflect"])
    new_throughput = throughput * branch_tint

    # strength is comparison-only (see _bounce_live): zero true gradient
    tr_strength = strength * refract_factor * linalg.norm(transmit_tint)
    sc_strength = (strength / _virtual_fanout(strength, add_factor, sc)
                   * add_factor * factor * linalg.norm(m["reflect"]))
    new_strength = jnp.where(take_transmit, tr_strength, sc_strength)

    o2 = jnp.where(new_alive[..., None], pos, o)
    d2 = jnp.where(new_alive[..., None], new_dir, d)
    throughput2 = jnp.where(new_alive[..., None], new_throughput, throughput)
    strength2 = jax.lax.stop_gradient(
        jnp.where(new_alive, new_strength, strength))
    return o2, d2, throughput2, strength2


def _float0_zeros(x):
    import numpy as np
    return np.zeros(np.shape(x), jax.dtypes.float0)


def _make_manual_bounce(scene: CompiledScene):
    """Custom-VJP bounce step: forward = live bounce, backward = jax.vjp
    of the decision-frozen replay.  Residuals per bounce shrink to
    (carry, ~7 decision lanes) and the reverse pass is a compact fused
    elementwise graph instead of autodiff through the 2L·L candidate
    fold."""

    def _ys(o, d, throughput, alive, dec):
        """Per-bounce emission inputs for the post-scan radiance sum,
        packed into ONE (B, 8) array: pos (3) | thr (3) | mat_id | live —
        one scan output, so one dynamic_update_slice per bounce instead
        of four.  pos is built from the FROZEN t and carries no gradient
        (d emissive/d pos ≡ 0 through nearest-texel gathers); thr is the
        bounce-input throughput (identity — its ys cotangent adds
        straight to the thr input cotangent, a (B, 3) slice at columns
        3:6 in the transpose).  mat_id/live ride as small-int-exact f32
        casts under stop_gradient."""
        sg = jax.lax.stop_gradient
        pos = sg(o + dec["t"][..., None] * d)
        tail = sg(jnp.stack(
            [dec["mat_id"].astype(jnp.float32),
             (alive & dec["hit"]).astype(jnp.float32)], axis=-1))
        return jnp.concatenate([pos, throughput, tail], axis=-1)

    @jax.custom_vjp
    def bounce_step(params, o, d, throughput, strength, alive,
                    k, in_depth, u_coin, u3):
        out, dec = _bounce_live(scene, params, o, d, throughput, strength,
                                alive, k, in_depth, u_coin=u_coin, u3=u3)
        return out, _ys(o, d, throughput, alive, dec)

    def fwd(params, o, d, throughput, strength, alive, k,
            in_depth, u_coin, u3):
        out, dec = _bounce_live(scene, params, o, d, throughput, strength,
                                alive, k, in_depth, u_coin=u_coin, u3=u3)
        # u_coin/u3 are NOT residuals: the replay consumes the saved
        # accepted draw u_sel, never the raw uniforms
        return (out, _ys(o, d, throughput, alive, dec)), (
            params, o, d, throughput, strength, alive, dec, k, in_depth)

    def bwd(res, ct):
        params, o, d, throughput, strength, alive, dec, k, in_depth = res
        (ct_o, ct_d, ct_thr, ct_stg, _ct_alive), ct_ys = ct
        # ys cotangents: pos is declared gradient-free (exact — see _ys);
        # thr (packed columns 3:6) is an identity output so its cotangent
        # adds directly
        ct_thr_ys = ct_ys[:, 3:6]

        def rep(params, o, d, throughput, strength):
            return _bounce_replay(scene, params, o, d, throughput, strength,
                                  alive, dec)

        _, vjp = jax.vjp(rep, params, o, d, throughput, strength)
        dparams, do, dd, dthr, dstg = vjp((ct_o, ct_d, ct_thr, ct_stg))
        return (dparams, do, dd, dthr + ct_thr_ys, dstg,
                _float0_zeros(alive),
                _float0_zeros(k), _float0_zeros(in_depth),
                jnp.zeros_like(strength), jnp.zeros_like(o))

    bounce_step.defvjp(fwd, bwd)
    return bounce_step


import functools as _functools


@_functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _pack_gather(cols, keep, tgt, cap):
    """Pack ``cols`` rows where ``keep`` to the front of a ``cap``-wide
    output — scatter-free in BOTH directions.

    The pack is a row gather at ``src = argsort(~keep)[:cap]`` (stable sort
    puts kept lanes first in lane order; the bool sort is cheap) and the
    hand-written transpose is a row gather of the cotangent at ``tgt``
    (the cumsum pack position, drop slot reading a zero pad row).  When
    fewer than ``cap`` lanes are kept, tail rows carry arbitrary dropped
    lanes — callers mask them via the packed alive column.
    """
    src = jnp.argsort(~keep, stable=True)[:cap]
    return cols[src], src


def _pack_gather_fwd(cols, keep, tgt, cap):
    return _pack_gather(cols, keep, tgt, cap), (keep, tgt)


def _pack_gather_bwd(cap, res, cts):
    keep, tgt = res
    ct, _ct_src = cts
    padded = jnp.concatenate(
        [ct, jnp.zeros((1,) + ct.shape[1:], ct.dtype)], axis=0)
    # kept rows read their pack position; dropped rows the zero pad row
    safe_tgt = jnp.where(keep & (tgt < cap), tgt, cap)
    return padded[safe_tgt], None, None


_pack_gather.defvjp(_pack_gather_fwd, _pack_gather_bwd)


def _compact_wavefront(carry, orig_idx, cap: int, key=None):
    """Compact live lanes into a ``cap``-wide wavefront (dead-lane
    compaction with static shapes and no data-dependent dispatch).

    Live lanes are packed to the front via a prefix-sum scatter with a
    drop slot.  If more than ``cap`` lanes are alive, *systematic
    resampling* keeps exactly ``cap`` of them, evenly spaced in lane
    order WITH A RANDOM PHASE OFFSET, and boosts surviving throughput by
    ``n/cap`` — the unbiased particle-filter estimator (future
    contributions are reweighted; past contributions were already
    banked).  The random offset is load-bearing for PER-PIXEL
    unbiasedness: without it the evenly-spaced keep pattern is a
    deterministic function of the alive mask, which repeats across
    samples and chunks, so the SAME pixels lose their post-compaction
    light in every sample — measured as 2-pixel-period bright/dark
    stripes through the demo lens (tools/parity_vs_reference.py block
    (560, 524): survivors boosted ~2×, dropped pixels near-black, block
    mean exactly right).  With the offset the kept subset varies per
    (key, phase) and the per-pixel expectation is restored.  (Radiance is
    not part of the carry — trace_rays accumulates each phase's emission
    post-scan, indexed by ``orig_idx``.)

    All selection state is integer/boolean (stop-gradient by nature);
    gather/scatter transposes are cheap and exact in reverse mode.
    """
    o, d, throughput, strength, alive = carry

    alive_i = alive.astype(jnp.int32)
    n = jnp.sum(alive_i)
    n_safe = jnp.maximum(n, 1)
    ncap = jnp.minimum(n_safe, cap)
    ranks = jnp.cumsum(alive_i)                      # 1-based among alive
    if key is not None:
        u = jax.random.uniform(key, ())
        off = jnp.floor(u * n_safe.astype(jnp.float32)).astype(jnp.int32)
        off = jnp.clip(off, 0, n_safe - 1)           # phase ∈ [0, n)
    else:
        off = jnp.int32(0)
    lo = ((ranks - 1) * ncap + off) // n_safe
    hi = (ranks * ncap + off) // n_safe
    keep = alive & (hi > lo)                         # exactly min(n, cap)
    w = jnp.where(n > cap, n_safe.astype(jnp.float32) / cap, 1.0)

    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1     # 0-based target
    tgt = jnp.where(keep, pos, cap)                  # cap = drop slot

    # ONE packed row gather moves all 12 carry columns (one index pass
    # instead of six); int32 columns ride along bitcast to f32 (exact).
    # Differentiable columns enter via (B, 3) CONCATENATION, not a stack
    # of (B,) columns, so the transpose yields (B, 3) slices rather than
    # (B, 1) arrays.  The non-differentiable tail
    # (strength is comparison-only, alive/orig are int-ish) rides under
    # stop_gradient so its transpose is pruned outright.
    f32 = lambda x: x.astype(jnp.float32)
    rest = jax.lax.stop_gradient(jnp.stack(
        [strength, f32(alive),
         jax.lax.bitcast_convert_type(orig_idx, jnp.float32)], axis=-1))
    cols = jnp.concatenate([o, d, throughput * w, rest], axis=1)  # (B, 12)
    out, _src = _pack_gather(cols, keep, tgt, cap)

    # under-full packs carry arbitrary dropped rows at the tail — mask
    # them dead (the gather-pack has no fill row)
    n_keep = jnp.minimum(ncap, cap)
    packed_live = jnp.arange(cap) < n_keep
    new_alive = packed_live & (out[:, 10] > 0.5)
    new_carry = (
        out[:, 0:3],
        # filler lanes get a safe unit direction (guarded math downstream)
        out[:, 3:6].at[:, 2].add(jnp.where(new_alive, 0.0, -1.0)),
        jnp.where(new_alive[:, None], out[:, 6:9], 0.0),
        jnp.where(new_alive, out[:, 9], 0.0),
        new_alive,
    )
    # drop sentinel on dead tail rows: any value ≥ the ORIGINAL width
    # (orig_idx shrinks per phase, so its own length is NOT safe); the
    # sentinel also keeps the orig vector nondecreasing for the radiance
    # scatter's indices_are_sorted promise
    new_orig = jnp.where(
        new_alive, jax.lax.bitcast_convert_type(out[:, 11], jnp.int32),
        jnp.int32(2 ** 31 - 1))
    return new_carry, new_orig


# Default compaction schedule: (start_bounce, width_divisor).  On the demo
# scene (512², depth 16) alive lanes fall to ~29% after the primary+first
# bounce and below 2% by bounce 6, so later phases run at 1/3 and 1/16
# width — fewer evaluated segments with identical expectation
# (randomized systematic-resampling overflow keeps it unbiased even for
# scenes where more survive).  A narrower second phase, (2,4), costs +3%
# equal-spp RMSE from resampling variance.
_COMPACT_SCHEDULE = ((2, 3), (6, 16))
_COMPACT_MIN_BATCH = 16384


def trace_rays(scene: CompiledScene, params, origin, direction, key,
               depth: int = DEFAULT_RAY_DEPTH, remat: bool = True,
               manual_vjp: bool | None = None,
               compact: bool | None = None,
               skysel: bool = True):
    """Trace a wavefront of rays to radiance estimates ``(..., 3)``.

    ``origin``/``direction`` have shape ``(..., 3)``; one stochastic path
    is followed per ray for up to ``depth`` bounces (+ the primary hit).

    Reverse mode: by default each bounce is a hand-written custom VJP
    (decision-frozen replay, see :func:`_make_manual_bounce`) whenever the
    scene has a fast hit path.  ``manual_vjp=False`` forces plain autodiff
    (kept as a cross-check oracle — tests/test_gradients.py); there
    ``remat`` rematerializes each bounce (O(1) residual memory; turn off
    when chunks leave headroom).

    ``compact``: dead-lane compaction between bounce phases (see
    :func:`_compact_wavefront`).  Default: on for large flat batches
    (≥ 16k rays) at depth ≥ 8 — production render/bench shapes — and off
    for the small deterministic-path batches tests use.  Changes which
    stochastic path each ray takes (not the estimator's expectation).

    ``skysel``: evaluate terminal dynamic-emissive chains (sky probes) on
    one bounce-selected lane per path instead of every post-scan lane
    (exact — see the post-scan block below).
    """
    batch_shape = origin.shape[:-1]
    # Flatten the wavefront to (B, 3); RNG draws are bit-identical either
    # way (threefry counter mode depends only on element count).
    if len(batch_shape) != 1:
        origin = origin.reshape(-1, 3)
        direction = direction.reshape(-1, 3)
    if manual_vjp is None:
        manual_vjp = scene.hit_fn is not None and scene.hit_replay_fn is not None

    if manual_vjp:
        if scene._manual_bounce is None:
            scene._manual_bounce = _make_manual_bounce(scene)
        bounce_step = scene._manual_bounce

        def bounce(carry, xs):
            bounce_idx, u_coin, u3 = xs
            o, d, throughput, strength, alive = carry
            k = rng.fold(key, bounce_idx)
            out, ys = bounce_step(params, o, d, throughput, strength, alive,
                                  k, bounce_idx < depth, u_coin, u3)
            return out, ys

        def phase_xs(start, end, width):
            """All of a phase's threefry draws in one pre-scan region —
            the same values the bounce would draw itself (fold(key, b)
            then streams 1 and 2), batched so the scan body contains no
            threefry work (bit-identical output).  vmap over the stacked
            per-bounce keys makes the whole phase ONE threefry evaluation
            per stream, and vmap of jax.random is value-identical to the
            per-key calls."""
            ks = jnp.stack([rng.fold(key, b) for b in range(start, end)])
            u_coins = jax.vmap(
                lambda kb: jax.random.uniform(rng.fold(kb, 1), (width,)))(ks)
            u3s = jax.vmap(
                lambda kb: jax.random.uniform(rng.fold(kb, 2),
                                              (width, 3)))(ks)
            return (jnp.arange(start, end), u_coins, u3s)
    else:
        def bounce(carry, bounce_idx):
            o, d, throughput, strength, alive = carry
            k = rng.fold(key, bounce_idx)
            out, dec = _bounce_live(scene, params, o, d, throughput,
                                    strength, alive, k, bounce_idx < depth)
            sg = jax.lax.stop_gradient
            ys = jnp.concatenate(
                [sg(o + dec["t"][..., None] * d), throughput,
                 sg(jnp.stack([dec["mat_id"].astype(jnp.float32),
                               (alive & dec["hit"]).astype(jnp.float32)],
                              axis=-1))], axis=-1)
            return out, ys
        if remat:
            bounce = jax.checkpoint(bounce)  # O(1) residuals/bounce

    B = origin.shape[0]
    init = (
        origin,
        direction,
        jnp.ones((B, 3), jnp.float32),
        jnp.ones((B,), jnp.float32),
        jnp.ones((B,), bool),
    )

    if compact is None:
        compact = B >= _COMPACT_MIN_BATCH and depth >= 8
    phases = [(0, 1)]
    if compact:
        phases += [(s, dv) for s, dv in _COMPACT_SCHEDULE
                   if s <= depth and B // dv >= 1]

    carry = init
    orig_idx = jnp.arange(B, dtype=jnp.int32)
    radiance = jnp.zeros((B, 3), jnp.float32)
    saved = []                       # (ys, orig_idx) per phase
    for pi, (start, div) in enumerate(phases):
        end = phases[pi + 1][0] if pi + 1 < len(phases) else depth + 1
        if pi > 0:
            carry, orig_idx = _compact_wavefront(
                carry, orig_idx, B // div,
                key=rng.fold(key, 0x00C0, pi))
        xs = (phase_xs(start, end, B // div) if manual_vjp
              else jnp.arange(start, end))
        carry, ys = jax.lax.scan(bounce, carry, xs)
        saved.append((ys, orig_idx))

    # ALL phases' emission in ONE texture evaluation (and, in reverse
    # mode, one image-gradient transpose + one const-table transpose):
    # phase lane blocks concatenate into a single flat batch.  Plain
    # autodiff handles the emissive parameter gradients here; the bounce
    # custom-VJP never sees them.
    #
    # Sky-select path (reference-scale probes): when the scene has
    # terminal dynamic-emissive materials (reflect ≡ transmit ≡ 0 — the
    # sky enclosure, test.cpp:134-140), each such chain is evaluated on
    # ONE bounce-selected lane per (phase, path) instead of every
    # post-scan lane: a terminal hit zeroes throughput exactly, so at most
    # one bounce per path has (mat terminal ∧ thr ≠ 0) — the select is
    # exact, cuts the image gather AND its scatter-add transpose from
    # Σ nb·Bp (~5.4·B) to Σ Bp (~1.6·B) rows, and runs as a one-hot sum
    # over the short bounce axis (no sort, no scatter).
    #
    # mat-sum fast path: when every dynamic emissive chain is terminal
    # (handled by sky-select), the base emission is a pure const-table
    # function of mat_id — so instead of a per-LANE table gather + a
    # select chain over every post-scan lane plus their transposes, fold
    # the throughput sum per MATERIAL (M masked reduces, all elementwise)
    # and multiply by the const rows once: contrib += Σ_m row_m · Σ_b
    # where(live ∧ mid=m, thr).  Gradients: d row_m is a plain reduce,
    # d thr a broadcast — no gathers, no scatters.
    term_chains = getattr(scene.material_fn, "terminal_dynamic_emissive",
                          [])
    use_skysel = bool(term_chains) and skysel
    dyn_mis = set(scene.material_fn.dynamic_slots["emissive"])
    term_mis = {mi for mi, _ in term_chains}
    mat_sum = use_skysel and dyn_mis <= term_mis
    if mat_sum:
        const_rows_em = np.asarray(
            scene.material_fn.const_idx["emissive"])
        em_cat = None
    else:
        em_eval = (scene.material_fn.eval_emissive_base if use_skysel
                   else scene.material_fn.eval_emissive)
        ys_cat = jnp.concatenate([ys.reshape(-1, 8) for ys, _ in saved])
        # pos re-enters stop_gradient HERE: the packed ys is
        # differentiable as a whole (thr columns), so a bare pos slice
        # would re-open a pos cotangent chain through the emission trig —
        # wasted transposes over every post-scan lane (d emissive/d pos
        # ≡ 0 through nearest gathers)
        em_cat = em_eval(
            params, jax.lax.stop_gradient(ys_cat[:, 0:3]),
            jax.lax.stop_gradient(ys_cat[:, 6]).astype(jnp.int32))

    sky_rows = []      # per phase: per terminal chain: (row (Bp, 8), has)
    sky_em = []        # per terminal chain: (ΣBp, 3) eval, split per phase
    if use_skysel:
        for ys, _ in saved:
            nb, Bp, _ = ys.shape
            mid = ys[..., 6]
            live = ys[..., 7] > 0.5
            thr_nz = jnp.sum(jnp.abs(ys[..., 3:6]), axis=-1) > 0.0
            per_chain = []
            for mi, _fn in term_chains:
                is_sel = live & (mid == float(mi)) & thr_nz
                first = jnp.argmax(is_sel, axis=0)               # (Bp,)
                oh = (jax.lax.broadcasted_iota(jnp.int32, (nb, Bp), 0)
                      == first[None, :])
                row = jnp.sum(jnp.where(oh[..., None], ys, 0.0), axis=0)
                per_chain.append((row, jnp.any(is_sel, axis=0)))
            sky_rows.append(per_chain)
        for ti, (mi, fn) in enumerate(term_chains):
            pos_cat = jnp.concatenate(
                [sky_rows[pi][ti][0][:, 0:3] for pi in range(len(saved))])
            sky_em.append(fn(params, jax.lax.stop_gradient(pos_cat)))

    ofs = 0
    sky_ofs = [0] * len(term_chains)
    for pi, (ys, orig) in enumerate(saved):
        nb, Bp, _ = ys.shape
        thr = ys[..., 3:6]
        live = ys[..., 7] > 0.5
        if mat_sum:
            mid = ys[..., 6]
            contrib = jnp.zeros((Bp, 3), jnp.float32)
            for m in range(scene.material_fn.n_materials):
                if m in term_mis:
                    continue        # terminal mats ride sky-select below
                wsum = jnp.sum(
                    jnp.where((live & (mid == float(m)))[..., None],
                              thr, 0.0), axis=0)
                contrib = contrib + wsum * params["const"][
                    int(const_rows_em[m])]
        else:
            em = em_cat[ofs:ofs + nb * Bp].reshape(nb, Bp, 3)
            ofs += nb * Bp
            contrib = jnp.sum(jnp.where(live[..., None], thr * em, 0.0),
                              axis=0)
        if use_skysel:
            for ti in range(len(term_chains)):
                row, has = sky_rows[pi][ti]
                em_t = sky_em[ti][sky_ofs[ti]:sky_ofs[ti] + Bp]
                sky_ofs[ti] += Bp
                contrib = contrib + jnp.where(
                    has[..., None], row[:, 3:6] * em_t, 0.0)
        if pi == 0:
            radiance = radiance + contrib
        else:
            # orig is strictly increasing over kept lanes (compaction
            # packs in lane order) and the clipped drop-sentinel tail is a
            # constant B−1, so the index vector is nondecreasing —
            # indices_are_sorted lets XLA skip the scatter sort phase.
            # unique_indices would NOT be honest: the clipped sentinels
            # duplicate B−1 (their added value is 0, but the promise is
            # about indices).
            radiance = radiance.at[jnp.clip(orig, 0, B - 1)].add(
                jnp.where((orig < B)[..., None], contrib, 0.0),
                indices_are_sorted=True)
    return radiance.reshape(batch_shape + (3,))
