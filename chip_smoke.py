#!/usr/bin/env python3
"""On-card smoke test: ptx's main paths, run once on a GPU.

    python chip_smoke.py              # one card: all single-card phases
    python chip_smoke.py --cards 4    # four cards: the sharded phase only

Each phase runs in its own child process, one after another, so only one
JAX process holds the card at a time; this parent process never imports
JAX.  Every phase prints one JSON line with its result, its wall and
compile seconds and the card's name and power limit.  The script stops at
the first failed phase with a non-zero exit code.  On success the last
line of standard output is ``{"ok": true, "device": {...}}`` with the
device as JAX reports it.

Phases (one card):

- ``device``: JAX's default backend must be the GPU.
- ``parity``: the GPU against the CPU backend on the same inputs — first
  hit on 65,536 primary rays for the flagship (dense path) and the
  composed scene (fixpoint union sweep); a 64×64, 4 spp, depth-16
  flagship image and the gradient of its mean radiance w.r.t. every
  parameter, with compaction and the manual VJP on.
- ``render``: ``python -m ptx render`` of the reference's production
  frame (the demo scene, 1920×1080, 10 spp, depth 16).
- ``large``: ``python -m ptx render --scene scenes/composed.json`` at its
  own settings.
- ``train``: three ``make_train_step`` steps on a one-card mesh.
- ``farm``: ``ptx serve`` on the card and a ``ptx farm`` client that
  never imports JAX, assembling a 512×512 frame from 32-px tiles.

With ``--cards 4`` the ``mesh4`` phase runs ``render_sharded`` and
``make_train_step`` on a (tiles=2, samples=2) mesh and compares both
with an unsharded replay of the same per-shard keys on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, ".work", "smoke")  # gitignored scratch outputs

SINGLE_CARD_PHASES = ("device", "parity", "render", "large", "train",
                      "farm")
FOUR_CARD_PHASES = ("device", "mesh4")

# Sizes of the full run.  The reference's production frame is the demo
# at 1920×1080, 10 spp, depth 16 (test.cpp:107-145).
FULL = {
    "hit_rays_side": 256,                 # 256² = 65,536 primary rays
    "parity_image": (64, 64, 4, 16),      # W = H, spp, depth
    "render": (1920, 1080, 10, 16),
    "train": (256, 16, 16, 3),            # side, spp, depth, steps
    "farm": (512, 32, 4, 16),             # side, tile, spp, depth
    "mesh4_flagship": (512, 16, 16),      # side, spp, depth
}

# Parity tolerances: GPU vs CPU on identical inputs and keys.  Threefry
# gives identical bits on both backends; what differs is f32 evaluation
# order (fusion, FMA contraction), the order of atomic adds in the
# scatter-adds (compaction's radiance scatter, the image-gradient
# transpose) and, downstream of a one-ulp difference, the rare lane whose
# decision flips at a near-tie (a grazing hit, a coin within an ulp of
# its threshold).  Each bound sits 25-100× above the value measured on an
# H100 (PERF.md) and below what a TF32 contraction (~5e-4 relative per
# term) would produce.
TOL = {
    # first hit: share of lanes whose hit / mat_id / entering differs
    # (measured 0 of 65,536 on both scenes)
    "hit_flip_frac": 1e-4,
    # first hit: relative t error on agreeing lanes (measured 4.0e-7)
    "hit_t_rel_max": 1e-5,
    # image: |mean_gpu − mean_cpu| / mean_cpu (measured 0)
    "img_mean_rel": 1e-5,
    # image: share of pixels off by more than 1e-3 relative — whole
    # path flips (measured 0; pixel max 6.1e-6)
    "img_pixel_frac": 1e-3,
    # value_and_grad: |loss_gpu − loss_cpu| / loss_cpu (measured 2.0e-7)
    "loss_rel": 1e-5,
    # value_and_grad: ‖g_gpu − g_cpu‖ / ‖g_cpu‖ over all parameters
    # (measured 8.9e-8)
    "grad_rel_l2": 1e-5,
    # mesh4: sharded vs unsharded replay, both on the GPU; the two
    # programs fuse differently, so a near-tie lane may flip a path
    "mesh_img_mean_rel": 1e-4,
    "mesh_img_pixel_frac": 1e-3,
    "mesh_loss_rel": 1e-4,
    "mesh_grad_rel_l2": 1e-3,
}


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

def card_info():
    sys.path.insert(0, ROOT)
    from ptx.utils.device import card_info as _card_info
    return _card_info()


def run_phase(name, cards):
    """Run one phase in a child process; returns its result dict."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", name,
         "--cards", str(cards)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=None, text=True)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        else:
            print(line, file=sys.stderr)
    if proc.returncode != 0 or result is None or not result.get("ok"):
        return {"phase": name, "ok": False, "rc": proc.returncode,
                "wall_s": time.time() - t0, "result": result}
    return result


def parent(args):
    if not os.path.isdir(os.path.join(ROOT, "ptx")):
        print("chip_smoke.py: the ptx package is not beside this script",
              file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card}", flush=True)
    phases = FOUR_CARD_PHASES if args.cards == 4 else SINGLE_CARD_PHASES
    for name in phases:
        res = run_phase(name, args.cards)
        res["card"] = card
        print(json.dumps(res), flush=True)
        if not res.get("ok"):
            print(f"chip_smoke.py: phase {name} failed", file=sys.stderr)
            return 1
        if name == "device":
            device = res["device"]
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# child phases (each runs in its own process)
# ---------------------------------------------------------------------------

def _setup_jax():
    sys.path.insert(0, ROOT)
    from ptx.utils.compile_cache import enable_compile_cache
    from ptx.utils.device import require_gpu
    device = require_gpu()
    enable_compile_cache()
    return device


def _timed(fn, *a):
    """(first-call seconds incl. compile, second-call seconds, output)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*a))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*a))
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, out


def phase_device(cards):
    device = _setup_jax()
    if device["count"] != cards:
        raise SystemExit(f"expected {cards} card(s), JAX sees "
                         f"{device['count']}")
    return {"device": device}


def _composed_world():
    from ptx.scenes.spec import SceneSpec
    world, cam, opts = SceneSpec.load(
        os.path.join(ROOT, "scenes", "composed.json")).build()
    return world, cam, opts


def first_hit_parity(scene, cam, side, cpu, gpu):
    """First hit on ``side²`` primary rays, GPU vs CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ptx.integrate.camera import Camera, sample_rays

    cam = Camera(side, side, cam.screen_width, cam.screen_height,
                 cam.screen_distance, cam.pose)
    o, d = sample_rays(cam, jax.random.PRNGKey(3), jnp.arange(side),
                       jnp.arange(side), 1)
    o = np.asarray(o).reshape(-1, 3)
    d = np.asarray(d).reshape(-1, 3)
    fn = jax.jit(scene.hit_fn)
    res = {}
    timing = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        args = jax.device_put((scene.params, o, d), dev)
        first, second, out = _timed(fn, *args)
        res[name] = {k: np.asarray(v) for k, v in out.items()}
        timing[name] = (first, second)
    g, c = res["gpu"], res["cpu"]
    agree = ((g["hit"] == c["hit"])
             & (~c["hit"] | ((g["mat_id"] == c["mat_id"])
                             & (g["entering"] == c["entering"]))))
    both = agree & c["hit"]
    t_rel = (np.abs(g["t"][both] - c["t"][both])
             / np.maximum(np.abs(c["t"][both]), 1.0))
    out = {
        "rays": int(o.shape[0]),
        "hit_lanes": int(c["hit"].sum()),
        "flip_lanes": int((~agree).sum()),
        "flip_frac": float((~agree).mean()),
        "t_rel_max": float(t_rel.max()) if t_rel.size else 0.0,
        "gpu_compile_s": timing["gpu"][0], "gpu_s": timing["gpu"][1],
    }
    out["ok"] = bool(out["flip_frac"] <= TOL["hit_flip_frac"]
                     and out["t_rel_max"] <= TOL["hit_t_rel_max"]
                     and out["hit_lanes"] > 0)
    return out


def image_grad_parity(scene, size, cpu, gpu):
    """Flagship image + value_and_grad(mean radiance), GPU vs CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.integrate.trace import trace_rays

    side, _, spp, depth = size
    cam = Camera.reference_demo(side, side)
    key = jax.random.PRNGKey(11)

    def image(params):
        o, d = sample_rays(cam, key, jnp.arange(side), jnp.arange(side), spp)
        rad = trace_rays(scene, params, o, d, key, depth, compact=True,
                         manual_vjp=True)
        return jnp.mean(rad, axis=0)

    def loss(params):
        return jnp.mean(image(params))

    img_fn = jax.jit(image)
    vg_fn = jax.jit(jax.value_and_grad(loss))
    res, timing = {}, {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        p = jax.device_put(scene.params, dev)
        t_img, _, img = _timed(img_fn, p)
        t_vg, t_vg2, (val, grads) = _timed(vg_fn, p)
        flat, _ = jax.flatten_util.ravel_pytree(grads)
        res[name] = (np.asarray(img), float(val), np.asarray(flat))
        timing[name] = (t_img, t_vg, t_vg2)
    (ig, vg, gg), (ic, vc, gc) = res["gpu"], res["cpu"]
    pix_rel = np.abs(ig - ic).max(-1) / np.maximum(np.abs(ic).max(-1), 1e-3)
    out = {
        "img_finite": bool(np.isfinite(ig).all()),
        "img_mean_gpu": float(ig.mean()), "img_mean_cpu": float(ic.mean()),
        "img_mean_rel": float(abs(ig.mean() - ic.mean()) / abs(ic.mean())),
        "img_pixel_frac": float((pix_rel > 1e-3).mean()),
        "img_pixel_rel_max": float(pix_rel.max()),
        "loss_rel": float(abs(vg - vc) / abs(vc)),
        "grad_rel_l2": float(np.linalg.norm(gg - gc)
                             / max(np.linalg.norm(gc), 1e-30)),
        "grad_finite": bool(np.isfinite(gg).all()),
        "gpu_compile_s": timing["gpu"][0] + timing["gpu"][1],
        "gpu_grad_s": timing["gpu"][2],
    }
    out["ok"] = bool(out["img_finite"] and out["grad_finite"]
                     and out["img_mean_rel"] <= TOL["img_mean_rel"]
                     and out["img_pixel_frac"] <= TOL["img_pixel_frac"]
                     and out["loss_rel"] <= TOL["loss_rel"]
                     and out["grad_rel_l2"] <= TOL["grad_rel_l2"])
    return out


def phase_parity(cards):
    import jax
    import jax.flatten_util  # noqa: F401
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.scenes.builders import make_world

    _setup_jax()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    side = FULL["hit_rays_side"]
    flagship = compile_scene(make_world())
    world, cam, _ = _composed_world()
    composed = compile_scene(world)
    res = {
        "hit_flagship": first_hit_parity(
            flagship, Camera.reference_demo(side, side), side, cpu, gpu),
        "hit_composed": first_hit_parity(composed, cam, side, cpu, gpu),
        "image_grad": image_grad_parity(flagship, FULL["parity_image"],
                                        cpu, gpu),
        "tolerances": TOL,
    }
    res["ok"] = all(v["ok"] for k, v in res.items() if k != "tolerances")
    return res


def _cli(argv, env=None):
    """Run ``python -m ptx ...``; returns (wall seconds, JSON log events,
    stdout text)."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "ptx"] + argv, cwd=ROOT,
                          capture_output=True, text=True, env=env)
    wall = time.time() - t0
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"ptx {argv[0]} exited {proc.returncode}")
    events = []
    for line in proc.stderr.splitlines():
        if line.startswith("{"):
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return wall, events, proc.stdout


def _check_frame(path, shape_hw):
    import numpy as np
    sys.path.insert(0, ROOT)
    from ptx.io import hdr
    img = hdr.read(path)[..., :3]
    return {"shape": list(img.shape), "finite": bool(np.isfinite(img).all()),
            "mean": float(img.mean()),
            "ok": bool(img.shape[:2] == tuple(shape_hw)
                       and np.isfinite(img).all() and img.mean() > 0)}


def _render_phase(argv, shape_hw, out_base):
    wall, events, _ = _cli(argv + ["--out", out_base])
    start = next(e for e in events if e.get("event") == "render_start")
    done = next(e for e in events if e.get("event") == "render_done")
    frame = _check_frame(out_base + ".hdr", shape_hw)
    # the CLI child picks its own backend: a failed CUDA start would
    # leave it on the CPU, so its device is checked here
    return {"wall_s": wall, "platform": start["platform"],
            "render_s": done["seconds"],
            "first_band_compile_s": done["first_band_s"],
            "rays_per_sec": done["rays_per_sec"], "frame": frame,
            "ok": bool(frame["ok"] and start["platform"] == "gpu")}


def phase_render(cards):
    w, h, spp, depth = FULL["render"]
    os.makedirs(OUT, exist_ok=True)
    res = _render_phase(
        ["render", "--demo", "demo", "--width", str(w), "--height", str(h),
         "--spp", str(spp), "--depth", str(depth)], (h, w),
        os.path.join(OUT, "render"))
    res.update(width=w, height=h, spp=spp, depth=depth)
    return res


def phase_large(cards):
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(ROOT, "scenes", "composed.json")) as f:
        cam = json.load(f)["camera"]
    return _render_phase(
        ["render", "--scene", os.path.join("scenes", "composed.json")],
        (cam["height"], cam["width"]), os.path.join(OUT, "large"))


def phase_train(cards):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.parallel import mesh as pmesh
    from ptx.parallel.render import make_train_step
    from ptx.scenes.builders import make_world

    _setup_jax()
    side, spp, depth, steps = FULL["train"]
    scene = compile_scene(make_world())
    cam = Camera.reference_demo(side, side)
    mesh = pmesh.make_mesh(jax.devices()[:1], tiles=1, samples=1)
    params0 = pmesh.shard_params(scene.params, mesh)
    target = jnp.zeros((side, side, 3), jnp.float32)
    key = jax.random.PRNGKey(5)
    # lr 3e-4 keeps the sky's HDR emission factor stable under SGD; at
    # that rate the sky-image update is below f32 resolution, so the
    # image cotangent is read off one extra step at lr 1e6, whose update
    # dwarfs every parameter: (params − new) / 1e6 is the gradient
    step = make_train_step(scene, cam, mesh, spp=spp, depth=depth,
                           learning_rate=3e-4, compact=True,
                           manual_vjp=True)
    params = params0
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, loss = jax.block_until_ready(
            step(params, target, jax.random.fold_in(key, i)))
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    probe = make_train_step(scene, cam, mesh, spp=spp, depth=depth,
                            learning_rate=1e6, compact=True,
                            manual_vjp=True)
    t0 = time.perf_counter()
    new, _ = jax.block_until_ready(probe(params0, target, key))
    probe_s = time.perf_counter() - t0
    img_grad = max(
        float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()) / 1e6
        for a, b in zip(jax.tree.leaves(params0["images"]),
                        jax.tree.leaves(new["images"])))
    leaves0 = jax.tree.leaves(params0)
    leaves1 = jax.tree.leaves(params)
    finite = all(np.isfinite(np.asarray(x)).all() for x in leaves1)
    moved = any(np.abs(np.asarray(a) - np.asarray(b)).max() > 0
                for a, b in zip(leaves0, leaves1) if np.size(a))
    return {"side": side, "spp": spp, "depth": depth, "losses": losses,
            "step_s": times, "first_step_compile_s": times[0],
            "grad_probe_s": probe_s, "params_finite": finite,
            "params_moved": moved, "sky_image_grad_max": img_grad,
            "ok": bool(all(np.isfinite(losses)) and finite and moved
                       and img_grad > 0)}


def phase_farm(cards):
    import numpy as np

    side, tile, spp, depth = FULL["farm"]
    os.makedirs(OUT, exist_ok=True)
    serve = subprocess.Popen(
        [sys.executable, "-m", "ptx", "serve", "--demo", "demo",
         "--width", str(side), "--height", str(side), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = serve.stdout.readline()
        if "server on :" not in line:
            raise SystemExit(f"ptx serve did not start: {line!r}")
        if "platform=gpu," not in line:
            raise SystemExit(f"ptx serve is not on the GPU: {line!r}")
        port = int(line.split("server on :")[1].split()[0])
        addr = f"127.0.0.1:{port}"
        # the client runs through cli.main and must never import JAX
        client = ("import sys; from ptx import cli; cli.main(sys.argv[1:]); "
                  "assert 'jax' not in sys.modules, 'farm client imported "
                  "jax'")

        def farm(frame_side, out):
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", client, "farm", addr, "--demo",
                 "demo", "--width", str(frame_side), "--height",
                 str(frame_side), "--tile", str(tile), "--spp", str(spp),
                 "--depth", str(depth), "--out", out],
                cwd=ROOT, capture_output=True, text=True)
            sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-2000:])
            if proc.returncode != 0:
                raise SystemExit(f"ptx farm exited {proc.returncode}")
            return time.time() - t0, proc.stdout
        # one tile first: the server compiles its tile program once
        warm_s, _ = farm(tile, os.path.join(OUT, "farm_warm"))
        frame_s, text = farm(side, os.path.join(OUT, "farm"))
    finally:
        serve.terminate()
        try:
            serve.wait(timeout=30)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
    n_tiles = (side // tile) ** 2
    tiles_ok = f"({n_tiles}/{n_tiles} tiles)" in text
    frame = _check_frame(os.path.join(OUT, "farm.hdr"), (side, side))
    return {"side": side, "tile": tile, "spp": spp, "depth": depth,
            "tiles": n_tiles, "all_tiles_arrived": tiles_ok,
            "first_tile_compile_s": warm_s, "frame_s": frame_s,
            "frame": frame, "ok": bool(tiles_ok and frame["ok"])}


def _mesh4_scene(scene, cam, spp, depth, mesh, key):
    """render_sharded + make_train_step on the mesh vs an unsharded
    replay of the same per-(tile, sample) keys on card 0."""
    import jax
    import jax.flatten_util
    import jax.numpy as jnp
    import numpy as np
    from ptx.core import rng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays
    from ptx.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
    from ptx.parallel.render import make_train_step, render_sharded

    tiles, samples = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    rows, spp_l = cam.height // tiles, spp // samples
    out = {"width": cam.width, "height": cam.height, "spp": spp,
           "depth": depth}

    t0 = time.perf_counter()
    img_s = np.asarray(render_sharded(scene, cam, mesh, key, spp=spp,
                                      depth=depth, compact=True,
                                      manual_vjp=True))
    out["render_sharded_first_s"] = time.perf_counter() - t0

    # learning rate 1e6: the update dwarfs every parameter, so
    # (params − new) / 1e6 recovers the psum'd gradient to f32 precision
    lr = 1e6
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    step = make_train_step(scene, cam, mesh, spp=spp, depth=depth,
                           learning_rate=lr, compact=True, manual_vjp=True)
    t0 = time.perf_counter()
    new, loss_s = jax.block_until_ready(step(scene.params, target, key))
    loss_s = float(loss_s)
    out["train_first_step_s"] = time.perf_counter() - t0
    grads_s = jax.tree.map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b)) / lr,
        scene.params, new)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(step(scene.params, target, key))
        times.append(time.perf_counter() - t0)
    out["train_step_s"] = times

    # the unsharded replay: one (tile, sample) shard at a time on card 0,
    # its image and its VJP for a given image cotangent in one program
    @jax.jit
    def shard(params, t, s, ct):
        def image(p):
            k = rng.fold(key, t, s)
            o, d = sample_rays(cam, k, t * rows + jnp.arange(rows),
                               jnp.arange(cam.width), spp_l)
            return jnp.mean(trace_rays(scene, p, o, d, k, depth,
                                       compact=True, manual_vjp=True),
                            axis=0)
        img, vjp = jax.vjp(image, params)
        return img, vjp(ct)[0]

    params0 = jax.device_put(scene.params, jax.devices()[0])
    zero = jnp.zeros((rows, cam.width, 3), jnp.float32)
    tile_imgs = [sum(np.asarray(shard(params0, t, s, zero)[0])
                     for s in range(samples)) / samples
                 for t in range(tiles)]
    img_u = np.concatenate(tile_imgs)
    pix_rel = (np.abs(img_s - img_u).max(-1)
               / np.maximum(np.abs(img_u).max(-1), 1e-3))
    out["render_mean_rel"] = float(abs(img_s.mean() - img_u.mean())
                                   / abs(img_u.mean()))
    out["render_pixel_frac"] = float((pix_rel > 1e-3).mean())
    out["render_finite"] = bool(np.isfinite(img_s).all())

    # loss = mean over tiles of mean(img_t²) (zero target), img_t the
    # mean of the tile's sample shards: each shard's VJP gets the
    # cotangent 2·img_t / (samples · rows·W·3), summed and averaged
    loss_u, grads_u = 0.0, None
    for t, img_t in enumerate(tile_imgs):
        loss_u += float(np.mean(img_t.astype(np.float64) ** 2)) / tiles
        ct = jnp.asarray(2.0 * img_t / (samples * img_t.size), jnp.float32)
        for s in range(samples):
            g = jax.tree.map(lambda x: np.asarray(x, np.float64) / tiles,
                             shard(params0, t, s, ct)[1])
            grads_u = g if grads_u is None else jax.tree.map(
                np.add, grads_u, g)
    fu = np.asarray(jax.flatten_util.ravel_pytree(grads_u)[0])
    fs = np.asarray(jax.flatten_util.ravel_pytree(grads_s)[0])
    out["loss_sharded"], out["loss_unsharded"] = loss_s, loss_u
    out["loss_rel"] = abs(loss_s - loss_u) / abs(loss_u)
    out["grad_rel_l2"] = float(np.linalg.norm(fs - fu)
                               / max(np.linalg.norm(fu), 1e-30))
    out["ok"] = bool(out["render_finite"]
                     and out["render_mean_rel"] <= TOL["mesh_img_mean_rel"]
                     and out["render_pixel_frac"]
                     <= TOL["mesh_img_pixel_frac"]
                     and out["loss_rel"] <= TOL["mesh_loss_rel"]
                     and out["grad_rel_l2"] <= TOL["mesh_grad_rel_l2"])
    return out


def phase_mesh4(cards):
    import jax
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.parallel import mesh as pmesh
    from ptx.scenes.builders import make_world

    _setup_jax()
    mesh = pmesh.make_mesh(jax.devices()[:4], tiles=2, samples=2)
    key = jax.random.PRNGKey(17)
    side, spp, depth = FULL["mesh4_flagship"]
    res = {"flagship": _mesh4_scene(
        compile_scene(make_world()), Camera.reference_demo(side, side),
        spp, depth, mesh, key)}
    world, cam, opts = _composed_world()
    res["composed"] = _mesh4_scene(compile_scene(world), cam,
                                   int(opts["spp"]), int(opts["depth"]),
                                   mesh, key)
    res["tolerances"] = {k: v for k, v in TOL.items()
                         if k.startswith("mesh")}
    res["ok"] = res["flagship"]["ok"] and res["composed"]["ok"]
    return res


PHASE_FNS = {"device": phase_device, "parity": phase_parity,
             "render": phase_render, "large": phase_large,
             "train": phase_train, "farm": phase_farm,
             "mesh4": phase_mesh4}


def child(name, cards):
    t0 = time.time()
    res = PHASE_FNS[name](cards)
    res = {"phase": name, "wall_s": time.time() - t0, **res}
    res.setdefault("ok", True)
    print("RESULT " + json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded four-card phase")
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return child(args.phase, args.cards)
    return parent(args)


if __name__ == "__main__":
    sys.exit(main())
