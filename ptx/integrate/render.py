"""Tile/chunk rendering driver.

The reference covers the screen with 32-px adaptive blocks scheduled onto a
pthread pool (test.cpp:325-518).  Here the analogue is static chunking: the
pixel grid × sample axis is split into uniform ray chunks, each rendered by
one fully-vectorized jitted dispatch; XLA's SPMD replaces the thread pool.
Chunks exist only to bound live memory (span lists are the footprint:
~1 KB/ray at K≈24), not to load-balance — work per ray is uniform by
construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ptx.core import rng
from ptx.core.constants import DEFAULT_RAY_DEPTH
from ptx.integrate.camera import Camera, sample_rays
from ptx.integrate.trace import CompiledScene, trace_rays


@partial(jax.jit, static_argnames=("scene", "cam", "rows", "cols", "spp",
                                   "depth", "compact"))
def _render_tile(scene: CompiledScene, params, cam: Camera, key,
                 x0, y0, cols: int, rows: int, spp: int, depth: int,
                 compact=None):
    """Render exactly the requested (x0, y0, cols, rows) pixel rectangle of
    the global camera — farm tiles trace only their own pixels (the
    reference's RenderBlock covers an arbitrary block the same way,
    test.cpp:325-341).  ``compact``: forwarded to trace_rays (the parity
    harness passes False — per-pixel comparisons need the low-variance
    estimator; compaction's overflow resampling adds per-pixel variance
    that is separately validated in tests/test_compaction.py)."""
    ys = y0 + jnp.arange(rows)
    xs = x0 + jnp.arange(cols)
    o, d = sample_rays(cam, key, ys, xs, spp)
    radiance = trace_rays(scene, params, o, d, key, depth, compact=compact)
    return jnp.mean(radiance, axis=0)          # (rows, cols, 3)


def _render_rows(scene: CompiledScene, params, cam: Camera, key,
                 y0, rows: int, spp: int, depth: int):
    return _render_tile(scene, params, cam, key, 0, y0, cam.width, rows,
                        spp, depth)


@partial(jax.jit, static_argnames=("scene", "cam", "rows", "spp_chunk",
                                   "n_chunks", "depth"))
def _render_rows_fori(scene: CompiledScene, params, cam: Camera, key,
                      y0, rows: int, spp_chunk: int, n_chunks: int,
                      depth: int):
    """All ``n_chunks · spp_chunk`` samples of a row band in ONE dispatch:
    a device-side fori_loop accumulates sample chunks into the band image.

    Why: a HOST loop over chunks pays one dispatch and one (rows, W, 3)
    output allocation per chunk; the device-side loop pays them once per
    band.  Keys fold exactly as the host-chunked path's ``fold(key, s, y0)``
    (s = chunk·spp_chunk), so the estimate matches it chunk-for-chunk.
    ``y0`` is a traced argument: one executable serves every band."""
    ys = y0 + jnp.arange(rows)
    xs = jnp.arange(cam.width)

    def body(i, acc):
        k = rng.fold(key, i * spp_chunk, y0)
        o, d = sample_rays(cam, k, ys, xs, spp_chunk)
        rad = trace_rays(scene, params, o, d, k, depth)
        return acc + jnp.mean(rad, axis=0)

    acc = jax.lax.fori_loop(
        0, n_chunks, body,
        jnp.zeros((rows, cam.width, 3), jnp.float32))
    return acc / n_chunks


def render(scene: CompiledScene, cam: Camera, key, spp: int = 16,
           depth: int = DEFAULT_RAY_DEPTH, params=None,
           rays_per_chunk: int = 2 ** 21, progress=None):
    """Render a full frame → (H, W, 3) float32 radiance.

    Splits the frame into row bands so each dispatch stays under
    ``rays_per_chunk`` rays.  ``params`` defaults to the scene's own
    (override for optimization loops).
    """
    params = scene.params if params is None else params
    rows_per_chunk = max(1, min(cam.height,
                                rays_per_chunk // max(1, cam.width * spp)))
    out = []
    y0 = 0
    while y0 < cam.height:
        rows = min(rows_per_chunk, cam.height - y0)
        chunk_key = rng.fold(key, y0)
        out.append(_render_rows(scene, params, cam, chunk_key,
                                y0, rows, spp, depth))
        if progress is not None:
            progress(min(y0 + rows, cam.height), cam.height)
        y0 += rows
    return jnp.concatenate(out, axis=0)


# CompiledScene participates in jit cache keys by identity (dataclass
# eq=False in trace.py); Camera by value (frozen dataclass, poses passed as
# tuples so it stays hashable).
