"""Compaction-schedule sweep at the current cost structure.

The live-fraction/cost trade behind ``trace._COMPACT_SCHEDULE`` moves
with the chunk shape, the emission path and the device.  Measures the
headline chunk fwd+bwd (median of 3 chained ≥2 s regions) per schedule;
the winner must then pass the RMSE guard (equal-spp RMSE vs
compact=False within noise) before becoming the default.

Usage: python tools/compact_sweep.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCHEDULES = [
    ((2, 3), (6, 16)),            # current default
    ((2, 4), (6, 16)),
    ((2, 3), (5, 16)),
    ((2, 3), (6, 24)),
    ((2, 2), (5, 8), (9, 32)),
    ((1, 2), (4, 8), (8, 32)),
]


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import ptx.integrate.trace as tr
    from ptx.core import rng as prng
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.scenes.builders import make_world

    width = height = 512
    depth = 16
    rows = height // 4
    scene = tr.compile_scene(make_world())
    cam = Camera.reference_demo(width, height)
    key = jax.random.PRNGKey(0)
    rays_per_chunk = rows * width * (depth + 1)

    for sched in SCHEDULES:
        tr._COMPACT_SCHEDULE = sched

        def chunk_loss(params, key, y0, i, acc):
            key = prng.fold(key, i)
            ys = y0 + jnp.arange(rows)
            o, d = sample_rays(cam, key, ys, jnp.arange(width), 1)
            radiance = tr.trace_rays(scene, params, o, d, key, depth,
                                     remat=False)
            return jnp.mean(radiance) + acc

        grad_fn = jax.jit(jax.value_and_grad(chunk_loss))

        def run_chain(n, i0=0):
            acc = jnp.float32(0.0)
            t0 = time.perf_counter()
            for i in range(n):
                y0 = jnp.int32((i % 4) * rows)
                acc = grad_fn(scene.params, key, y0, jnp.int32(i0 + i),
                              acc)[0]
            assert np.isfinite(float(acc))
            return time.perf_counter() - t0

        run_chain(1)                       # compile
        pilot = run_chain(16, i0=100)
        n = min(4096, max(64, int(16 * 2.0 / max(pilot, 1e-6))))
        dts = sorted(run_chain(n, i0=1000 + 7000 * r) for r in range(3))
        mrps = rays_per_chunk * n / dts[1] / 1e6
        print(json.dumps({"schedule": list(map(list, sched)),
                          "fwd_bwd_mrps": round(mrps, 2),
                          "spread": [round(rays_per_chunk * n / d / 1e6, 1)
                                     for d in dts]}), flush=True)


if __name__ == "__main__":
    main()
