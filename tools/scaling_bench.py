"""Mesh-scaling harness.

Measures rays/s and parallel efficiency for the sharded render AND the
sharded train step across device-count subsets and mesh shapes, at FIXED
GLOBAL WORK — the strong-scaling curve the BASELINE metric asks for
(≥90% linear 1→4 devices).  Runs unchanged on:

- the 8-device virtual CPU mesh (validates the harness; its times are
  CPU times, not device numbers), and
- the GPUs of one host: ``python tools/scaling_bench.py --devices 1,2,4
  --width 512 --height 512 --spp 64``.

Timing: dependent-dispatch chains ending in a scalar fetch.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/scaling_bench.py            # virtual-mesh run
    python tools/scaling_bench.py --devices 1,2,4 --width 64 ...
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _meshes(n):
    """Mesh shapes to test at n devices: tile-major, sample-major, square."""
    shapes = {(n, 1), (1, n)}
    import math
    r = int(math.isqrt(n))
    while r > 1:
        if n % r == 0:
            shapes.add((n // r, r))
            break
        r -= 1
    return sorted(shapes)


def run(args):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.parallel import mesh as pmesh
    from ptx.parallel.render import make_train_step, render_sharded
    from ptx.scenes.builders import make_world
    from ptx.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    devices = jax.devices()
    counts = [int(c) for c in args.devices.split(",")]
    counts = [c for c in counts if c <= len(devices)]
    cam = Camera(args.width, args.height)
    spp, depth = args.spp, args.depth
    rays = args.width * args.height * spp * (depth + 1)
    key = jax.random.PRNGKey(0)

    scene = compile_scene(make_world())

    base = {}
    for n in counts:
        for (tiles, samples) in _meshes(n):
            if cam.height % tiles or spp % samples:
                continue
            m = pmesh.make_mesh(devices[:n], tiles=tiles, samples=samples)

            # --- render: chain frames through a scalar digest ---------
            def render_once(acc, i):
                img = render_sharded(scene, cam, m, jax.random.fold_in(
                    key, i), spp=spp, depth=depth)
                return acc + jnp.mean(img)

            acc = jnp.float32(0.0)
            acc = render_once(acc, 0)
            float(acc)                      # compile + settle
            t0 = time.perf_counter()
            iters = args.iters
            for i in range(iters):
                acc = render_once(acc, i + 1)
            assert np.isfinite(float(acc))
            dt_r = (time.perf_counter() - t0) / iters

            # --- train step: full fwd+bwd with psum'd grads -----------
            target = render_sharded(scene, cam, m, key, spp=spp,
                                    depth=depth)
            step = make_train_step(scene, cam, m, spp=spp, depth=depth,
                                   learning_rate=0.0)
            params, loss = step(scene.params, target,
                                jax.random.fold_in(key, 99))
            float(loss)
            t0 = time.perf_counter()
            for i in range(iters):
                params, loss = step(params, target,
                                    jax.random.fold_in(key, 100 + i))
            assert np.isfinite(float(loss))
            dt_t = (time.perf_counter() - t0) / iters

            row = {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "devices": n, "tiles": tiles, "samples": samples,
                   "render_mrps": round(rays / dt_r / 1e6, 3),
                   "train_mrps": round(rays / dt_t / 1e6, 3)}
            if 1 in base:
                row["render_eff"] = round(
                    row["render_mrps"] / (base[1]["render_mrps"] * n), 3)
                row["train_eff"] = round(
                    row["train_mrps"] / (base[1]["train_mrps"] * n), 3)
            base.setdefault(n, row)
            print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma list of device counts to test")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--iters", type=int, default=4)
    run(ap.parse_args())


if __name__ == "__main__":
    main()
