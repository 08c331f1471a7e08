"""Device time of each integrator layer as XLA compiles it, from a
``jax.profiler`` trace, plus scene-build time per fresh process.

    python tools/layer_profile.py [--out DIR]

Layers, each jitted alone at a 65,536-ray wavefront (256² primary rays)
and traced over a few warm calls:

- ``first_hit``: ``scene.hit_fn`` (flagship: dense fold; composed:
  fixpoint union sweep);
- ``bounce``: one live bounce (first hit + shade + scatter); shade+scatter
  is ``bounce − first_hit``;
- ``sky_chain``: the sky's emissive texture chain (the sky-select
  evaluation) on every lane, and ``sky_chain_grad`` its gradient w.r.t.
  the sky image; the image-gradient transpose is their difference;
- ``replay_bwd``: the VJP of the decision-frozen bounce replay;
- ``step_fwd`` / ``step_fwd_bwd``: a whole 65,536-ray, depth-16
  ``trace_rays`` chunk (per bounce: divide by 17).

Device time is the union of the kernel intervals on the GPU's stream
lines of the trace, per call (the reader in ``tools/profile_step.py``).
Prints one JSON line per measurement; the card's name and power limit
come first.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.profile_step import busy_us, device_events  # noqa: E402

ITERS = 5


def measure(name, fn, args, outdir):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    logdir = os.path.join(outdir, name)
    t0 = time.perf_counter()
    with jax.profiler.trace(logdir, create_perfetto_trace=True):
        for _ in range(ITERS):
            jax.block_until_ready(fn(*args))
    wall = (time.perf_counter() - t0) / ITERS
    events, lines = device_events(logdir)
    busy = busy_us(events)
    row = {"layer": name, "device_ms": busy / ITERS / 1e3,
           "host_wall_ms_traced": wall * 1e3, "first_call_s": compile_s,
           "stream_lines": lines}
    print(json.dumps(row), flush=True)
    return row


def layers(scene_name, scene, cam, outdir, side=256, chunk=(512, 128)):
    import jax
    import jax.numpy as jnp
    from ptx.core import rng
    from ptx.integrate import trace as tr
    from ptx.integrate.camera import Camera, sample_rays

    cam = Camera(side, side, cam.screen_width, cam.screen_height,
                 cam.screen_distance, cam.pose)
    key = jax.random.PRNGKey(0)
    o, d = sample_rays(cam, key, jnp.arange(side), jnp.arange(side), 1)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    B = o.shape[0]
    p = scene.params
    carry = (o, d, jnp.ones((B, 3)), jnp.ones(B), jnp.ones(B, bool))
    u_coin = jax.random.uniform(rng.fold(key, 1), (B,))
    u3 = jax.random.uniform(rng.fold(key, 2), (B, 3))
    rows = {}

    def put(name, fn, *args):
        rows[name] = measure(f"{scene_name}/{name}", jax.jit(fn), args,
                             outdir)

    put("first_hit", scene.hit_fn, p, o, d)

    def bounce(p, o, d):
        return tr._bounce_live(scene, p, o, d, *carry[2:], key, True,
                               u_coin=u_coin, u3=u3)
    put("bounce", bounce, p, o, d)

    (_, dec) = jax.jit(bounce)(p, o, d)
    term = scene.material_fn.terminal_dynamic_emissive
    if term:
        hit = jax.jit(scene.hit_fn)(p, o, d)
        pos = o + hit["t"][:, None] * d
        sky = term[0][1]
        w = jax.random.uniform(key, (B, 3))
        put("sky_chain", lambda p, pos: sky(p, pos), p, pos)

        def sky_grad(images, p, pos):
            return jax.grad(lambda im: jnp.sum(
                sky({**p, "images": im}, pos) * w))(images)
        put("sky_chain_grad", sky_grad, p["images"], p, pos)

    cts = tuple(jax.random.normal(jax.random.fold_in(key, i), (B, 3))
                for i in range(3))

    def replay_bwd(p, o, d):
        def rep(p, o, d, thr, st):
            return tr._bounce_replay(scene, p, o, d, thr, st, carry[4], dec)
        _, vjp = jax.vjp(rep, p, o, d, carry[2], carry[3])
        return vjp((*cts, jnp.zeros(B)))
    put("replay_bwd", replay_bwd, p, o, d)

    # a whole 65,536-ray chunk at depth 16: 512 wide × 128 rows × 1 spp
    cw, ch = chunk
    ccam = Camera(cw, cw, cam.screen_width * cw / side,
                  cam.screen_height * cw / side,
                  cam.screen_distance * cw / side, cam.pose)
    co, cd = sample_rays(ccam, key, jnp.arange(ch), jnp.arange(cw), 1)

    def chunk_loss(p):
        return jnp.mean(tr.trace_rays(scene, p, co, cd, key, 16,
                                      remat=False))
    put("step_fwd", chunk_loss, p)
    put("step_fwd_bwd", jax.value_and_grad(chunk_loss), p)

    derived = {"layer": f"{scene_name}/shade_scatter (bounce - first_hit)",
               "device_ms": rows["bounce"]["device_ms"]
               - rows["first_hit"]["device_ms"]}
    print(json.dumps(derived), flush=True)
    if term:
        print(json.dumps({
            "layer": f"{scene_name}/image_grad_transpose "
                     "(sky_chain_grad - sky_chain)",
            "device_ms": rows["sky_chain_grad"]["device_ms"]
            - rows["sky_chain"]["device_ms"]}), flush=True)
    for k in ("step_fwd", "step_fwd_bwd"):
        print(json.dumps({"layer": f"{scene_name}/{k} per bounce (/17)",
                          "device_ms": rows[k]["device_ms"] / 17}),
              flush=True)


_BUILD = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import jax
gpu = jax.devices()[0]
jax.block_until_ready(jax.device_put(0.0, gpu))
from ptx.integrate.trace import compile_scene
from ptx.scenes.builders import make_world
from ptx.scenes.spec import SceneSpec
out = {{}}
for name in ("demo", "composed"):
    t0 = time.perf_counter()
    world = (make_world() if name == "demo" else
             SceneSpec.load({root!r} + "/scenes/composed.json").build()[0])
    scene = compile_scene(world)
    jax.block_until_ready(jax.device_put(scene.params, gpu))
    out[name + "_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def scene_build_times(runs=2):
    """Scene build (builder + compile_scene + params on the card), each
    run in a fresh process, after the backend is up."""
    rows = []
    for _ in range(runs):
        proc = subprocess.run(
            [sys.executable, "-c", _BUILD.format(root=ROOT)],
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-3000:])
            raise SystemExit("scene build probe failed")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"scene_build": row}), flush=True)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, ".work",
                                                  "layer_traces"))
    args = ap.parse_args()
    from ptx.utils.device import card_info
    print(f"card: {card_info()}", flush=True)
    scene_build_times()

    from ptx.utils.compile_cache import enable_compile_cache
    from ptx.utils.device import require_gpu
    print(json.dumps({"device": require_gpu()}), flush=True)
    enable_compile_cache()
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.scenes.builders import make_world
    from ptx.scenes.spec import SceneSpec

    layers("flagship", compile_scene(make_world()),
           Camera.reference_demo(256, 256), args.out)
    world, cam, _ = SceneSpec.load(
        os.path.join(ROOT, "scenes", "composed.json")).build()
    layers("composed", compile_scene(world), cam, args.out)


if __name__ == "__main__":
    main()
