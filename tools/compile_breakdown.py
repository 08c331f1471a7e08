"""Flagship cold-compile breakdown: splits bench.py's `bench_compile`
wall into its stages for the production grad chunk (512² demo, H/4
rows, depth 16, compact):

  scene_build   — compile_scene (tape + tables built, nothing lowered)
  trace_lower   — jax trace + StableHLO lowering (host CPU)
  backend       — XLA compilation for the device

Run with an empty cache directory to see the real first-user cost:
  JAX_COMPILATION_CACHE_DIR=$(mktemp -d) python tools/compile_breakdown.py
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--fwd-only", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ptx.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    from ptx.core import rng as prng
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.integrate.trace import compile_scene, trace_rays
    from ptx.scenes.builders import make_world

    width = height = 512
    rows = height // 4
    t0 = time.perf_counter()
    scene = compile_scene(make_world())
    cam = Camera.reference_demo(width, height)
    t_scene = time.perf_counter() - t0

    key = jax.random.PRNGKey(0)

    def chunk_loss(params, key, i):
        key = prng.fold(key, i)
        ys = jnp.arange(rows)
        o, d = sample_rays(cam, key, ys, jnp.arange(width), 1)
        radiance = trace_rays(scene, params, o, d, key, args.depth,
                              remat=False)
        return jnp.mean(radiance)

    fn = (chunk_loss if args.fwd_only
          else jax.value_and_grad(chunk_loss))
    t0 = time.perf_counter()
    lowered = jax.jit(fn).lower(scene.params, key, jnp.int32(0))
    t_lower = time.perf_counter() - t0
    hlo_bytes = len(lowered.as_text())

    t0 = time.perf_counter()
    compiled = lowered.compile()
    t_backend = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = compiled(scene.params, key, jnp.int32(0))
    v = float(out[0] if isinstance(out, tuple) else out)
    t_first = time.perf_counter() - t0
    assert v == v

    print(json.dumps({
        "event": "compile_breakdown",
        "mode": "fwd" if args.fwd_only else "grad",
        "scene_build_s": round(t_scene, 2),
        "trace_lower_s": round(t_lower, 2),
        "backend_compile_s": round(t_backend, 2),
        "first_exec_s": round(t_first, 2),
        "stablehlo_chars": hlo_bytes,
        "cache": cache,
    }))


if __name__ == "__main__":
    main()
