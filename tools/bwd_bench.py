"""Manual-VJP vs autodiff backward benchmark on the real chip.

Usage: python tools/bwd_bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(spp_chunk, rows, manual, remat=False, width=512, depth=16):
    import jax
    import jax.numpy as jnp
    from ptx.core import rng as prng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays

    scene, cam = run.scene, run.cam

    def chunk_loss(params, key, y0, i):
        key = prng.fold(key, i)
        ys = y0 + jnp.arange(rows)
        o, d = sample_rays(cam, key, ys, jnp.arange(width), spp_chunk)
        radiance = trace_rays(scene, params, o, d, key, depth,
                              remat=remat, manual_vjp=manual)
        return jnp.mean(radiance)

    grad_fn = jax.jit(jax.value_and_grad(chunk_loss))
    fwd_fn = jax.jit(chunk_loss)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    loss, grads = grad_fn(scene.params, key, jnp.int32(0), jnp.int32(0))
    jax.block_until_ready(grads)
    comp = time.perf_counter() - t0
    jax.block_until_ready(fwd_fn(scene.params, key, jnp.int32(0),
                                 jnp.int32(0)))

    n = 16
    t0 = time.perf_counter()
    for i in range(n):
        loss, grads = grad_fn(scene.params, key, jnp.int32((i % 2) * rows),
                              jnp.int32(i))
    jax.block_until_ready(grads)
    dt_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n):
        out = fwd_fn(scene.params, key, jnp.int32((i % 2) * rows),
                     jnp.int32(1000 + i))
    jax.block_until_ready(out)
    dt_f = time.perf_counter() - t0

    rays = rows * width * spp_chunk * (depth + 1) * n
    return {"spp_chunk": spp_chunk, "rows": rows, "manual": manual,
            "remat": remat,
            "fwd_bwd_mrps": round(rays / dt_g / 1e6, 2),
            "fwd_mrps": round(rays / dt_f / 1e6, 2),
            "bwd_over_fwd": round(dt_g / dt_f, 2),
            "compile_s": round(comp, 1), "loss": float(loss)}


def main():
    import jax
    from ptx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.scenes.builders import make_world

    run.scene = compile_scene(make_world())
    run.cam = Camera.reference_demo(512, 512)

    for cfg in [(1, 256, True), (1, 256, False), (2, 64, True),
                (2, 64, False), (1, 512, True), (1, 128, True),
                (2, 256, True), (4, 256, True)]:
        spp_chunk, rows, manual = cfg
        try:
            print(json.dumps(run(spp_chunk, rows, manual)), flush=True)
        except Exception as e:
            print(json.dumps({"cfg": cfg, "error": repr(e)[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
