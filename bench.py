"""Headline benchmark: rays/sec/chip, forward + backward, on the flagship
CSG scene at 512×512 / 64 spp / depth 16 (BASELINE.json metric).

A "ray" is one path segment slot evaluated against the full scene
(primary hit or bounce): rays = H · W · spp · (depth + 1).  The wavefront
evaluates every segment slot regardless of liveness — that uniformity is
the design — so the count is exact, not an estimate.

Timing construct
----------------
The timed regions are chains of DEPENDENT dispatches: every chunk's
scalar loss is added into an accumulator that feeds the next chunk's
program, and the region ends with a fetch of the final scalar, which
forces the whole chain to complete.  The timed region is sized to
≥ ~2 s via a warm pilot chain.  A second construct runs the whole
gradient-accumulation loop as ONE device-side ``fori_loop`` dispatch.

Cross-check: a full 512²×64spp frame is rendered end-to-end as ONE
dispatch (the whole sample×band loop is a device-side ``fori_loop``) with
one final frame fetch, and its wall-clock rays/s is reported next to the
chained number.

The benchmark runs only on a GPU: it exits non-zero on any other
backend, and prints the card's name and power limit on a line before
its JSON result.

vs_baseline
-----------
The reference publishes no numbers, but it was *measured* on a 4-core
CPU host: built from source with ``-DSERVER_ONLY`` (g++ -O3)
and driven over its own TCP block protocol on the demo scene at its
default 1920×1080 / 10 spp / depth 16 / adaptive-block config, on the
4-core host.  Results:

- full frame: 43/45 blocks in 475 s with 8 in flight; the two blocks
  covering the diffuse spheres exceed 600 s each (a 64-px block centered
  on a diffuse sphere took 175 s alone — 23 px/s/thread, the
  ``scatter_ray_count``=10000 fan-out); conservative full-frame wall
  time: 600 s.
- nominal segment throughput (crediting its adaptive interpolation as if
  every pixel were traced): 1920·1080·10·17 / 600 s = 0.587 Mrays/s for
  the whole host.

``vs_baseline`` = our **forward+backward** rays/s (which includes
gradient work the reference cannot do at all) divided by the reference
host's forward-only 0.587 Mrays/s — a conservative ratio.
"""

import json
import time

# Measured reference-host throughput (see module docstring).
REF_HOST_RAYS_PER_SEC = 0.587e6

TARGET_TIMED_SECONDS = 3.0


def bench_device(width=512, height=512, spp=64, depth=16, spp_chunk=1,
              frame_check=True, sky=None):
    """``sky``: optional (H, W) for a synthetic equirect probe replacing
    the default 64×128 — the reference's demo rides a 3k HDR probe
    (test.cpp:123), so the headline must also be reported under
    reference-scale texture pressure:
    ``python bench.py --sky 1536x3072``."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from ptx.core import rng as prng
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.integrate.trace import compile_scene, trace_rays
    from ptx.scenes.builders import make_world
    from ptx.utils.profiling import log

    from ptx.scenes.builders import procedural_sky_image
    sky_img = procedural_sky_image(*sky) if sky else None
    scene = compile_scene(make_world(sky_image=sky_img))
    cam = Camera.reference_demo(width, height)
    key = jax.random.PRNGKey(0)
    # chunk rows: H/4 bands (65k-ray chunks at spp_chunk=1); the
    # big-probe variants take H/2 bands (the image transpose amortizes
    # over more lanes).  Not yet re-swept on the GPU.
    rows = height // (2 if sky else 4)
    n_bands = height // rows
    rays_per_chunk = rows * width * spp_chunk * (depth + 1)

    def chunk_loss(params, key, y0, i, acc):
        # ``acc`` chains this chunk's program onto the previous chunk's
        # output, so the timed dispatches cannot overlap
        key = prng.fold(key, i)        # fold inside jit: no host dispatch
        ys = y0 + jnp.arange(rows)
        o, d = sample_rays(cam, key, ys, jnp.arange(width), spp_chunk)
        radiance = trace_rays(scene, params, o, d, key, depth,
                              remat=False)   # chunks are small: residuals fit
        return jnp.mean(radiance) + acc

    grad_fn = jax.jit(jax.value_and_grad(chunk_loss))
    fwd_fn = jax.jit(chunk_loss)

    def run_chain(fn, n, i0=0):
        """n dependent dispatches; returns elapsed seconds INCLUDING the
        final scalar bytes fetch (the completion barrier)."""
        acc = jnp.float32(0.0)
        t0 = time.perf_counter()
        for i in range(n):
            y0 = jnp.int32((i % n_bands) * rows)
            out = fn(scene.params, key, y0, jnp.int32(i0 + i), acc)
            acc = out[0] if isinstance(out, tuple) else out
        val = float(acc)               # bytes fetch: forces the whole chain
        assert np.isfinite(val)
        return time.perf_counter() - t0

    # warmup / compile
    t0 = time.perf_counter()
    run_chain(grad_fn, 1)
    log("bench_compile", seconds=round(time.perf_counter() - t0, 1))
    run_chain(fwd_fn, 1)

    # pilot: size the timed region to >= TARGET_TIMED_SECONDS (also
    # absorbs the contaminated first post-compile iterations)
    pilot_s = run_chain(grad_fn, 8, i0=100)
    chunks_timed = max(n_bands * (spp // spp_chunk),
                       int(8 * TARGET_TIMED_SECONDS / max(pilot_s, 1e-6)))
    chunks_timed = min(chunks_timed, 4096)

    # forward chunks are ~2× faster — size its region separately so both
    # timed regions reach the target length
    chunks_fwd = min(2 * chunks_timed, 4096)
    dt_grad = run_chain(grad_fn, chunks_timed)
    dt_fwd = run_chain(fwd_fn, chunks_fwd, i0=10_000)

    # the pilot runs hot on post-compile contamination and overestimates
    # per-chunk cost — if a region undershot the target, rescale once
    # from the region's own (clean) rate
    if dt_grad < TARGET_TIMED_SECONDS * 0.8:
        chunks_timed = min(4096, int(
            chunks_timed * TARGET_TIMED_SECONDS / max(dt_grad, 1e-6)))
    if dt_fwd < TARGET_TIMED_SECONDS * 0.8:
        chunks_fwd = min(4096, int(
            chunks_fwd * TARGET_TIMED_SECONDS / max(dt_fwd, 1e-6)))

    # MEDIAN of 3 regions: a single region is not a benchmark of record
    dts_grad = sorted(run_chain(grad_fn, chunks_timed, i0=20_000 + 5000 * r)
                      for r in range(3))
    dts_fwd = sorted(run_chain(fwd_fn, chunks_fwd, i0=40_000 + 5000 * r)
                     for r in range(3))
    dt_grad, dt_fwd = dts_grad[1], dts_fwd[1]

    chained_fwd_bwd_rps = rays_per_chunk * chunks_timed / dt_grad
    fwd_rps = rays_per_chunk * chunks_fwd / dt_fwd
    log("bench_measured_chained",
        fwd_bwd_mrps=round(chained_fwd_bwd_rps / 1e6, 2),
        fwd_mrps=round(fwd_rps / 1e6, 2),
        fwd_bwd_spread_mrps=[round(rays_per_chunk * chunks_timed / d / 1e6,
                                   1) for d in dts_grad],
        chunks=chunks_timed, rays_per_chunk=rays_per_chunk,
        timed_seconds=round(dt_grad, 2))

    # ---- benchmark of record: ONE-DISPATCH fwd+bwd wall -----------------
    # The whole gradient-accumulation loop (every chunk's value_and_grad,
    # summed grads — exactly a training accumulation step) runs as a
    # device-side fori_loop in ONE dispatch ending in a bytes fetch: the
    # chained construct is exposed to host dispatch latency, and
    # production renders/training put the loop on device anyway.  The
    # chained region stays as a cross-check + lower bound.
    n_wall = max(8, min(2048, chunks_timed))

    @jax.jit
    def grad_wall(params, key):
        def body(i, carry):
            acc, g = carry
            y0 = (jnp.int32(i) % n_bands) * rows
            v, gi = jax.value_and_grad(chunk_loss)(
                params, key, y0, jnp.int32(i), acc)
            return v, jax.tree.map(jnp.add, g, gi)

        g0 = jax.tree.map(jnp.zeros_like, params)
        return jax.lax.fori_loop(0, n_wall, body, (jnp.float32(0.0), g0))

    acc, grads = grad_wall(scene.params, key)        # compile + warm
    assert np.isfinite(float(acc))
    dts_wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        acc, grads = grad_wall(scene.params, key)
        val = float(acc)                             # bytes fetch barrier
        dts_wall.append(time.perf_counter() - t0)
        assert np.isfinite(val)
    dt_wall = sorted(dts_wall)[1]
    fwd_bwd_rps = rays_per_chunk * n_wall / dt_wall
    log("bench_measured",
        fwd_bwd_mrps=round(fwd_bwd_rps / 1e6, 2),
        construct="one_dispatch_grad_wall", chunks=n_wall,
        spread_mrps=[round(rays_per_chunk * n_wall / d / 1e6, 1)
                     for d in sorted(dts_wall)],
        chained_fwd_bwd_mrps=round(chained_fwd_bwd_rps / 1e6, 2),
        timed_seconds=round(dt_wall, 2))

    if frame_check:
        wall = frame_wall_check(scene, cam, key, spp, depth, rows,
                                fwd_rps)
    return fwd_bwd_rps, fwd_rps


def frame_wall_check(scene, cam, key, spp, depth, rows, bench_fwd_rps):
    """End-to-end full-frame render, wall clock: the whole sample × band
    loop runs as ONE device-side ``fori_loop`` dispatch, then one frame
    fetch — so wall clock is device time plus a single launch + transfer.
    Reports wall rays/s next to the chained bench number."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ptx.core import rng as prng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays
    from ptx.utils.profiling import log

    width, height = cam.width, cam.height
    n_bands = height // rows

    @jax.jit
    def frame_one_dispatch(params, key):
        # the loop body renders every band of one sample and adds the
        # FULL frame to the carry — a pure elementwise add XLA keeps
        # in-place in the loop carry (a per-band dynamic_update_slice
        # carry would copy the whole accumulator each iteration)
        def body(s, acc):
            bands = []
            for b in range(n_bands):
                y0 = b * rows
                k = prng.fold(key, s, y0)
                ys = y0 + jnp.arange(rows)
                o, d = sample_rays(cam, k, ys, jnp.arange(width), 1)
                rad = trace_rays(scene, params, o, d, k, depth,
                                 remat=False)
                bands.append(jnp.mean(rad, axis=0))     # (rows, W, 3)
            return acc + jnp.concatenate(bands, axis=0)

        acc = jnp.zeros((height, width, 3), jnp.float32)
        return jax.lax.fori_loop(0, spp, body, acc) / spp

    # warm (compile); completion of the warm run is forced by the fetch
    np.asarray(frame_one_dispatch(scene.params, key))

    t0 = time.perf_counter()
    frame_dev = frame_one_dispatch(scene.params, key)
    t1 = time.perf_counter()
    frame = np.asarray(frame_dev)      # one full-frame fetch
    t2 = time.perf_counter()
    assert np.isfinite(frame).all() and frame.shape == (height, width, 3)

    rays = width * height * spp * (depth + 1)
    wall_rps = rays / (t2 - t0)
    agree = abs(wall_rps - bench_fwd_rps) / bench_fwd_rps
    log("bench_frame_wall_check",
        wall_mrps=round(wall_rps / 1e6, 2),
        bench_fwd_mrps=round(bench_fwd_rps / 1e6, 2),
        fetch_seconds=round(t2 - t1, 3),
        rel_diff_vs_bench_fwd=round(agree, 3))
    return wall_rps


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sky", default=None,
                    help="HxW synthetic probe size (e.g. 1536x3072)")
    ap.add_argument("--no-frame-check", action="store_true")
    args = ap.parse_args(argv)
    sky = tuple(int(v) for v in args.sky.split("x")) if args.sky else None

    from ptx.utils.compile_cache import enable_compile_cache
    from ptx.utils.device import card_info, require_gpu
    device = require_gpu()
    enable_compile_cache()
    fwd_bwd_rps, fwd_rps = bench_device(sky=sky,
                                        frame_check=not args.no_frame_check)
    print(f"card: {card_info()}")
    name = "rays_per_sec_per_chip_fwd_bwd_512x512_64spp_depth16"
    if sky:
        name += f"_sky{sky[0]}x{sky[1]}"
    result = {
        "metric": name,
        "value": round(fwd_bwd_rps, 1),
        "unit": "rays/s",
        "vs_baseline": round(fwd_bwd_rps / REF_HOST_RAYS_PER_SEC, 2),
        "device": device,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
