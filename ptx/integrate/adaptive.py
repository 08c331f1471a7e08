"""Variance-guided adaptive sampling.

The reference concentrates work via recursive block subdivision: a square
whose 4 corner colors agree within ``minimumColorDelta`` is bilinearly
interpolated, otherwise it splits 4-way and traces more pixels
(``/root/reference/src/test.cpp:423-498``).  That control flow is
per-pixel-divergent — poison for a SIMD machine — and it *interpolates*
pixels it never traced.

The array-first re-conception keeps the objective (samples where variance
is) with uniform-shaped work:

1. a dense base pass renders every pixel at ``spp_base``, tracking
   per-pixel sample mean and M2 (so the variance of the mean is known);
2. each refinement round ranks pixels by estimated mean-variance
   (``top_k`` — a fixed-size, static-shape selection), gathers exactly
   ``k`` ray bundles, traces them in one dispatch, and scatter-adds into
   the accumulators.

Every pixel is truly sampled (no interpolated never-traced pixels), every
dispatch is dense, and the sample budget concentrates in the same places
the reference's subdivision would — edges, caustics, glass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ptx.core import rng
from ptx.core.constants import DEFAULT_RAY_DEPTH
from ptx.integrate.camera import Camera, pixel_rays
from ptx.integrate.trace import CompiledScene, trace_rays


@partial(jax.jit, static_argnames=("scene", "cam", "rows", "spp", "depth"))
def _base_rows(scene, params, cam: Camera, key, y0, rows: int, spp: int,
               depth: int):
    ys = (y0 + jnp.arange(rows)).astype(jnp.float32)
    xs = jnp.arange(cam.width).astype(jnp.float32)
    py, px = jnp.meshgrid(ys, xs, indexing="ij")
    shape = (spp, rows, cam.width)
    jitter = rng.sample_square(key, shape)
    o, d = pixel_rays(cam, jnp.broadcast_to(px, shape),
                      jnp.broadcast_to(py, shape), jitter)
    radiance = trace_rays(scene, params, o, d, key, depth)  # (spp, rows, W, 3)
    return jnp.sum(radiance, axis=0), jnp.sum(radiance ** 2, axis=0)


def _base_pass(scene, params, cam: Camera, key, spp: int, depth: int,
               rays_per_chunk: int = 2 ** 21):
    """Dense base pass, chunked through row bands so full-resolution frames
    (the reference's 1920×1080 default) never dispatch a frame×spp tensor
    in one go."""
    rows_per_chunk = max(1, min(cam.height,
                                rays_per_chunk // max(1, cam.width * spp)))
    s1_parts, s2_parts = [], []
    y0 = 0
    while y0 < cam.height:
        rows = min(rows_per_chunk, cam.height - y0)
        k = rng.fold(key, y0)
        s1p, s2p = _base_rows(scene, params, cam, k, y0, rows, spp, depth)
        s1_parts.append(s1p)
        s2_parts.append(s2p)
        y0 += rows
    s1 = jnp.concatenate(s1_parts, axis=0)
    s2 = jnp.concatenate(s2_parts, axis=0)
    count = jnp.full((cam.height, cam.width), spp, jnp.float32)
    return s1, s2, count


@partial(jax.jit, static_argnames=("cam", "k"))
def _rank_pixels(cam: Camera, s1, s2, count, k: int):
    # variance of the pixel-mean estimate: s²/n
    mean = s1 / count[..., None]
    var = jnp.maximum(s2 / count[..., None] - mean ** 2, 0.0)
    priority = jnp.sum(var, axis=-1) / count
    _, flat_idx = jax.lax.top_k(priority.reshape(-1), k)
    return flat_idx


@partial(jax.jit, static_argnames=("scene", "cam", "spp", "depth"))
def _refine_chunk(scene, params, cam: Camera, key, s1, s2, count,
                  flat_idx, spp: int, depth: int):
    py = (flat_idx // cam.width).astype(jnp.float32)
    px = (flat_idx % cam.width).astype(jnp.float32)

    shape = (spp,) + flat_idx.shape
    jitter = rng.sample_square(key, shape)
    o, d = pixel_rays(cam, jnp.broadcast_to(px, shape),
                      jnp.broadcast_to(py, shape), jitter)
    radiance = trace_rays(scene, params, o, d, key, depth)   # (spp, k, 3)
    add1 = jnp.sum(radiance, axis=0)
    add2 = jnp.sum(radiance ** 2, axis=0)

    s1 = s1.reshape(-1, 3).at[flat_idx].add(add1).reshape(s1.shape)
    s2 = s2.reshape(-1, 3).at[flat_idx].add(add2).reshape(s2.shape)
    count = count.reshape(-1).at[flat_idx].add(spp).reshape(count.shape)
    return s1, s2, count


def _refine_round(scene, params, cam: Camera, key, s1, s2, count,
                  k: int, spp: int, depth: int,
                  rays_per_chunk: int = 2 ** 21):
    """One ranked refinement round, gather-chunked so k·spp rays never
    exceed ``rays_per_chunk`` per dispatch (full-resolution frames rank
    hundreds of thousands of pixels)."""
    flat_idx = _rank_pixels(cam, s1, s2, count, k)
    k_chunk = max(1, min(k, rays_per_chunk // max(1, spp)))
    c0 = 0
    while c0 < k:
        cur = min(k_chunk, k - c0)
        idx = flat_idx[c0:c0 + cur]
        s1, s2, count = _refine_chunk(scene, params, cam,
                                      rng.fold(key, c0), s1, s2, count,
                                      idx, spp, depth)
        c0 += cur
    return s1, s2, count


def render_adaptive(scene: CompiledScene, cam: Camera, key,
                    spp_base: int = 8, rounds: int = 4,
                    frac: float = 0.125, spp_refine: int = 16,
                    depth: int = DEFAULT_RAY_DEPTH, params=None,
                    state=None, mesh=None, on_round=None):
    """Adaptive full-frame render → (image (H, W, 3), counts (H, W)).

    Total budget ≈ spp_base + rounds·frac·spp_refine samples/pixel,
    concentrated on the highest-variance ``frac`` of pixels each round.

    Durability/scale composition (the reference's
    adaptive sampler was its *default* driver, test.cpp:325-518, so it
    must compose with the rest of the machinery):

    - ``state``: optional ``(s1, s2, count, rounds_done)`` from a
      checkpoint; the base pass is skipped when counts exist and only
      the remaining rounds run.  The refinement sequence is a
      deterministic function of (state, key), so resume ≡ uninterrupted.
    - ``mesh``: optional device mesh — the dense base pass (the bulk of
      the budget) renders via shard_map moments
      (ptx.parallel.render.render_sharded_moments).  Refinement rounds
      are gather-shaped and stay single-program.
    - ``on_round(s1, s2, count, rounds_done)``: checkpoint hook called
      after the base pass and each round.

    Returns ``(image, counts, state)``.
    """
    params = scene.params if params is None else params
    k = max(1, int(cam.height * cam.width * frac))
    if state is not None and int(state[3]) >= 0 and state[2] is not None:
        s1, s2, count = (jnp.asarray(state[0]), jnp.asarray(state[1]),
                         jnp.asarray(state[2]))
        rounds_done = int(state[3])
    else:
        if mesh is not None:
            from ptx.parallel.render import render_sharded_moments
            s1, s2 = render_sharded_moments(scene, cam, mesh, key,
                                            spp=spp_base, depth=depth,
                                            params=params)
            count = jnp.full((cam.height, cam.width), spp_base,
                             jnp.float32)
        else:
            s1, s2, count = _base_pass(scene, params, cam, key, spp_base,
                                       depth)
        rounds_done = 0
        if on_round is not None:
            on_round(s1, s2, count, rounds_done)
    for r in range(rounds_done, rounds):
        s1, s2, count = _refine_round(scene, params, cam,
                                      rng.fold(key, 1000 + r),
                                      s1, s2, count, k, spp_refine, depth)
        if on_round is not None:
            on_round(s1, s2, count, r + 1)
    return (s1 / count[..., None], count,
            (s1, s2, count, rounds))


# --------------------------------------------------------------------------
# farm-tile adaptive rendering
# --------------------------------------------------------------------------
# In the reference, distributed rendering IS adaptive rendering: the farm
# server constructs a RenderBlock for every requested block and its run()
# is the recursive corner-similarity subdivision
# (/root/reference/src/test.cpp:503-504,708).  The ptx farm server mirrors
# that by running the variance-guided sampler PER TILE at the client's
# requested budget: base pass at half the budget, the rest concentrated on
# the highest-variance pixels of the tile.


@partial(jax.jit, static_argnames=("scene", "cam", "rows", "cols", "spp",
                                   "depth"))
def _base_tile(scene, params, cam: Camera, key, x0, y0, cols: int,
               rows: int, spp: int, depth: int):
    ys = (y0 + jnp.arange(rows)).astype(jnp.float32)
    xs = (x0 + jnp.arange(cols)).astype(jnp.float32)
    py, px = jnp.meshgrid(ys, xs, indexing="ij")
    shape = (spp, rows, cols)
    jitter = rng.sample_square(key, shape)
    o, d = pixel_rays(cam, jnp.broadcast_to(px, shape),
                      jnp.broadcast_to(py, shape), jitter)
    radiance = trace_rays(scene, params, o, d, key, depth)
    return jnp.sum(radiance, axis=0), jnp.sum(radiance ** 2, axis=0)


@partial(jax.jit, static_argnames=("scene", "cam", "cols", "spp", "depth",
                                   "k"))
def _refine_tile(scene, params, cam: Camera, key, x0, y0, cols: int,
                 s1, s2, count, spp: int, depth: int, k: int):
    mean = s1 / count[..., None]
    var = jnp.maximum(s2 / count[..., None] - mean ** 2, 0.0)
    priority = jnp.sum(var, axis=-1) / count
    _, flat_idx = jax.lax.top_k(priority.reshape(-1), k)
    py = (y0 + flat_idx // cols).astype(jnp.float32)
    px = (x0 + flat_idx % cols).astype(jnp.float32)
    shape = (spp,) + flat_idx.shape
    jitter = rng.sample_square(key, shape)
    o, d = pixel_rays(cam, jnp.broadcast_to(px, shape),
                      jnp.broadcast_to(py, shape), jitter)
    radiance = trace_rays(scene, params, o, d, key, depth)   # (spp, k, 3)
    s1 = s1.reshape(-1, 3).at[flat_idx].add(
        jnp.sum(radiance, axis=0)).reshape(s1.shape)
    s2 = s2.reshape(-1, 3).at[flat_idx].add(
        jnp.sum(radiance ** 2, axis=0)).reshape(s2.shape)
    count = count.reshape(-1).at[flat_idx].add(spp).reshape(count.shape)
    return s1, s2, count


def render_adaptive_tile(scene: CompiledScene, params, cam: Camera, key,
                         x0, y0, cols: int, rows: int, spp: int,
                         depth: int, rounds: int = 2, frac: float = 0.25):
    """Adaptive render of one farm tile at the SAME total sample budget a
    dense render of the tile at ``spp`` would use: base pass at
    ``spp // 2``, remainder concentrated on the top-``frac`` variance
    pixels over ``rounds`` rounds.  Returns the (rows, cols, 3) mean
    image — a drop-in for render._render_tile in the farm server."""
    spp_base = max(1, spp // 2)
    remaining = max(0, spp - spp_base)
    k = max(1, int(rows * cols * frac))
    spp_refine = max(1, int(round(remaining * rows * cols /
                                  max(1, rounds * k))))
    s1, s2 = _base_tile(scene, params, cam, key, x0, y0, cols, rows,
                        spp_base, depth)
    count = jnp.full((rows, cols), spp_base, jnp.float32)
    for r in range(rounds if remaining else 0):
        s1, s2, count = _refine_tile(scene, params, cam,
                                     rng.fold(key, 2000 + r), x0, y0,
                                     cols, s1, s2, count, spp_refine,
                                     depth, k)
    return s1 / count[..., None]
