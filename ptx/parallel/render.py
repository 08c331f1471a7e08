"""Sharded rendering and the gradient training step.

``render_sharded`` maps the frame over a (tiles × samples) mesh with
``shard_map``: every device traces its row-band at its sample share, a
``psum``-mean over the sample axis merges estimates, and the output image
lands row-sharded across the tile axis.  Rendering a sharded frame is
bitwise independent of the mesh shape given the same per-(row, sample
shard) RNG keys.

``make_train_step`` is the differentiable-rendering analogue of a data-
parallel training step: forward renders under the current scene params,
the loss compares against a target image, and parameter gradients are
``psum``'d over *both* mesh axes (every device owns different pixels AND
different samples) — the allreduce the BASELINE scaling metric
measures, overlapped with the backward pass by XLA's scheduler.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ptx.core import rng
from ptx.core.constants import DEFAULT_RAY_DEPTH
from ptx.integrate.camera import Camera, sample_rays
from ptx.integrate.trace import CompiledScene, trace_rays
from ptx.parallel.mesh import SAMPLE_AXIS, TILE_AXIS


def _local_render(scene, cam, depth, spp_local, params, key, y0, rows,
                  remat=True, compact=None, manual_vjp=None):
    """Render ``rows`` rows starting at (traced) ``y0`` with
    ``spp_local`` samples; used inside shard_map so axis indices decorrelate
    RNG across devices.  ``compact``/``manual_vjp`` pass through to
    :func:`trace_rays` — production renders run phase compaction and the
    custom-VJP bounce INSIDE shard_map, so tests/dryruns must be able to
    force them at small per-device batches."""
    tile_idx = jax.lax.axis_index(TILE_AXIS)
    samp_idx = jax.lax.axis_index(SAMPLE_AXIS)
    k = rng.fold(key, tile_idx, samp_idx)
    ys = y0 + jnp.arange(rows)
    xs = jnp.arange(cam.width)
    o, d = sample_rays(cam, k, ys, xs, spp_local)
    radiance = trace_rays(scene, params, o, d, k, depth, remat=remat,
                          compact=compact, manual_vjp=manual_vjp)
    local_mean = jnp.mean(radiance, axis=0)
    return jax.lax.pmean(local_mean, SAMPLE_AXIS)


def render_sharded(scene: CompiledScene, cam: Camera, mesh, key,
                   spp: int = 16, depth: int = DEFAULT_RAY_DEPTH,
                   params=None, compact=None, manual_vjp=None):
    """Full-frame render over the mesh → (H, W, 3), rows sharded over
    ``tiles``.  ``cam.height`` must divide by the tile axis; ``spp`` by the
    sample axis."""
    params = scene.params if params is None else params
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if cam.height % n_tiles or spp % n_samp:
        raise ValueError("height/spp must divide the mesh axes")
    rows = cam.height // n_tiles
    spp_local = spp // n_samp

    def body(params, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        y0 = tile_idx * rows
        img = _local_render(scene, cam, depth, spp_local, params, key, y0,
                            rows, compact=compact, manual_vjp=manual_vjp)
        return img

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False,   # scan carries start mesh-invariant by design
    )
    return jax.jit(fn)(params, key)


def render_sharded_moments(scene: CompiledScene, cam: Camera, mesh, key,
                           spp: int = 16, depth: int = DEFAULT_RAY_DEPTH,
                           params=None):
    """Like :func:`render_sharded` but returns per-pixel sample moments
    ``(s1, s2)`` — Σ radiance and Σ radiance² over all ``spp`` samples,
    full-frame (H, W, 3) — the inputs the adaptive sampler's variance
    ranking needs (ptx.integrate.adaptive).  Sums psum over the sample
    axis so any mesh shape yields the same totals."""
    params = scene.params if params is None else params
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if cam.height % n_tiles or spp % n_samp:
        raise ValueError("height/spp must divide the mesh axes")
    rows = cam.height // n_tiles
    spp_local = spp // n_samp

    def body(params, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        samp_idx = jax.lax.axis_index(SAMPLE_AXIS)
        y0 = tile_idx * rows
        k = rng.fold(key, tile_idx, samp_idx)
        ys = y0 + jnp.arange(rows)
        o, d = sample_rays(cam, k, ys, jnp.arange(cam.width), spp_local)
        rad = trace_rays(scene, params, o, d, k, depth)
        s1 = jax.lax.psum(jnp.sum(rad, axis=0), SAMPLE_AXIS)
        s2 = jax.lax.psum(jnp.sum(rad ** 2, axis=0), SAMPLE_AXIS)
        return s1, s2

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(TILE_AXIS, None, None), P(TILE_AXIS, None, None)),
        check_vma=False,
    )
    return jax.jit(fn)(params, key)


def make_train_step(scene: CompiledScene, cam: Camera, mesh,
                    spp: int = 16, depth: int = DEFAULT_RAY_DEPTH,
                    learning_rate: float = 1e-2, remat: bool = True,
                    compact=None, manual_vjp=None):
    """Build a jitted SGD step: ``step(params, target, key) ->
    (params, loss)`` with gradients allreduced over the mesh.

    ``target`` is the full (H, W, 3) image (sharded over rows like the
    render output).  Inverse-rendering optimization of scene parameters is
    this framework's "training loop".
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    rows = cam.height // n_tiles
    spp_local = spp // n_samp

    def local_loss(params, target_rows, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        y0 = tile_idx * rows
        img = _local_render(scene, cam, depth, spp_local, params, key,
                            y0, rows, remat=remat, compact=compact,
                            manual_vjp=manual_vjp)
        return jnp.mean((img - target_rows) ** 2)

    def body(params, target_rows, key):
        loss, grads = jax.value_and_grad(local_loss)(params, target_rows, key)
        # every device saw different pixels and samples: mean over the mesh
        grads = jax.lax.pmean(jax.lax.pmean(grads, TILE_AXIS), SAMPLE_AXIS)
        loss = jax.lax.pmean(jax.lax.pmean(loss, TILE_AXIS), SAMPLE_AXIS)
        new_params = jax.tree.map(
            lambda p, g: p - learning_rate * g, params, grads)
        return new_params, loss

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS, None, None), P()),
        out_specs=(P(), P()),
        check_vma=False,   # scan carries start mesh-invariant by design
    )
    return jax.jit(fn)
