"""Chunk-configuration sweep for the headline benchmark.

Measures fwd+bwd and fwd rays/s on the device across (spp_chunk,
rows-divisor, remat) so bench.py can run the best known configuration
(the benchmark of record must report capability, not a detuned one).

Usage: python tools/bench_sweep.py [--quick]
"""

import argparse
import json
import os
import sys
import time

# run as `python tools/bench_sweep.py`: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(width, height, spp, depth, spp_chunk, rows, remat, iters=3):
    import jax
    import jax.numpy as jnp
    from ptx.core import rng as prng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays

    scene = measure.scene
    cam = measure.cam
    key = jax.random.PRNGKey(0)

    def chunk_loss(params, key, y0, i):
        key = prng.fold(key, i)
        ys = y0 + jnp.arange(rows)
        o, d = sample_rays(cam, key, ys, jnp.arange(width), spp_chunk)
        radiance = trace_rays(scene, params, o, d, key, depth, remat=remat)
        return jnp.mean(radiance)

    grad_fn = jax.jit(jax.value_and_grad(chunk_loss))
    fwd_fn = jax.jit(chunk_loss)

    t0 = time.perf_counter()
    loss, grads = grad_fn(scene.params, key, jnp.int32(0), jnp.int32(0))
    jax.block_until_ready(grads)
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(fwd_fn(scene.params, key, jnp.int32(0),
                                 jnp.int32(0)))

    n_bands = max(1, height // rows)
    chunks_timed = min(n_bands * max(1, spp // spp_chunk), 6 * iters)

    t0 = time.perf_counter()
    for i in range(chunks_timed):
        y0 = jnp.int32((i % n_bands) * rows)
        loss, grads = grad_fn(scene.params, key, y0, jnp.int32(i))
    jax.block_until_ready(grads)
    dt_grad = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(chunks_timed):
        y0 = jnp.int32((i % n_bands) * rows)
        out = fwd_fn(scene.params, key, y0, jnp.int32(1000 + i))
    jax.block_until_ready(out)
    dt_fwd = time.perf_counter() - t0

    rays = rows * width * spp_chunk * (depth + 1) * chunks_timed
    return rays / dt_grad, rays / dt_fwd, compile_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax
    from ptx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.scenes.builders import make_world

    width = height = 512
    spp, depth = 64, 16
    measure.scene = compile_scene(make_world())
    measure.cam = Camera.reference_demo(width, height)

    configs = [
        # (spp_chunk, rows, remat)
        (2, height // 8, False),
        (2, height // 4, False),
        (2, height // 2, False),
        (4, height // 8, False),
        (4, height // 4, False),
        (1, height // 2, False),
        (1, height, False),
        (2, height, False),
        (4, height // 2, False),
        (8, height // 8, False),
    ]
    if args.quick:
        configs = configs[:4]

    results = []
    for spp_chunk, rows, remat in configs:
        try:
            g, f, comp = measure(width, height, spp, depth, spp_chunk, rows,
                                 remat)
            r = {"spp_chunk": spp_chunk, "rows": rows, "remat": remat,
                 "rays": rows * width * spp_chunk,
                 "fwd_bwd_mrps": round(g / 1e6, 2),
                 "fwd_mrps": round(f / 1e6, 2),
                 "compile_s": round(comp, 1)}
        except Exception as e:  # OOM etc.
            r = {"spp_chunk": spp_chunk, "rows": rows, "remat": remat,
                 "error": repr(e)[:120]}
        results.append(r)
        print(json.dumps(r), flush=True)

    best = max((r for r in results if "fwd_bwd_mrps" in r),
               key=lambda r: r["fwd_bwd_mrps"], default=None)
    print("BEST:", json.dumps(best))


if __name__ == "__main__":
    main()
