"""Command-line driver — the reference ``main()``'s successor
(``/root/reference/src/test.cpp:800-1096``).

Modes (reference flags in parentheses):

- ``ptx render scene.json`` — render to ``image%08X.bmp`` + ``.hdr`` (the
  hex-epoch naming of test.cpp:1057,1070); ``--novideo`` was the headless
  flag — headless is our default, ``--preview`` adds a live terminal
  half-block preview (the SDL window's successor).
- ``ptx render --demo`` — the built-in ``makeWorld`` demo scene.
- ``ptx serve`` (``--server``) — TCP render-farm worker: accepts tile
  requests, renders on the local device, streams tiles back.  Run one
  server per card (pin it with ``CUDA_VISIBLE_DEVICES`` on a host with
  several): a JAX process reserves most of its card's memory.
- ``ptx farm addr [addr...]`` (``--client``) — farm tiles to servers and
  assemble the frame locally.  The client never imports JAX, so it can
  run beside a server on the same card's host.
- ``ptx bench`` — the headline benchmark (same as bench.py).

Checkpoint/resume: ``--checkpoint path.npz`` accumulates per-pixel sample
sums; interrupting and re-running continues from the recorded sample count.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _frame_settings(args):
    """``(width, height, spp, depth)``: the flags first, then the scene
    file's ``render``/``camera`` blocks, then the reference defaults.
    Reads the scene file as plain JSON — no JAX import (the farm client
    needs only these four numbers)."""
    doc = {}
    if args.scene:
        with open(args.scene) as f:
            doc = json.load(f)
    cam_doc, opts = doc.get("camera", {}), doc.get("render", {})
    width = (args.width or int(opts.get("width", 0))
             or int(cam_doc.get("width", 640)))
    height = (args.height or int(opts.get("height", 0))
              or int(cam_doc.get("height", 480)))
    spp = args.spp or int(opts.get("spp", 10))
    depth = args.depth or int(opts.get("depth", 16))
    return width, height, spp, depth


def _build_scene(args):
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.scenes import builders
    from ptx.scenes.spec import SceneSpec

    width, height, spp, depth = _frame_settings(args)
    if args.scene:
        world, cam, _ = SceneSpec.load(args.scene).build()
        if (cam.width, cam.height) != (width, height):
            cam = Camera(width, height, cam.screen_width, cam.screen_height,
                         cam.screen_distance, cam.pose)
    else:
        world = {
            "demo": builders.make_world,
            "config1": builders.baseline_config1,
            "config2": builders.baseline_config2,
            "config3": builders.baseline_config3,
            "config4": builders.baseline_config4,
        }[args.demo or "demo"]()
        cam = Camera.reference_demo(width, height)
    return compile_scene(world), cam, spp, depth


def _terminal_preview(img):
    """ANSI half-block live preview — the SDL surface's terminal successor."""
    import numpy as np
    h, w = img.shape[:2]
    cols = min(80, w)
    rows = min(44, h - h % 2)
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = np.clip(img[ys][:, xs] * 256, 0, 255).astype(int)
    out = []
    for y in range(0, rows - 1, 2):
        line = []
        for x in range(cols):
            t, b = small[y, x], small[y + 1, x]
            line.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                        f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        out.append("".join(line) + "\x1b[0m")
    sys.stdout.write("\x1b[H\x1b[2J" + "\n".join(out) + "\n")
    sys.stdout.flush()


def cmd_render(args):
    import numpy as np
    import jax

    from ptx.core import rng as prng
    from ptx.integrate.render import _render_rows
    from ptx.io import bmp as bmp_io, hdr as hdr_io
    from ptx.parallel.checkpoint import RenderAccumulator

    scene, cam, spp, depth = _build_scene(args)

    if args.adaptive:
        from ptx.integrate.adaptive import render_adaptive
        from ptx.parallel.checkpoint import AdaptiveCheckpoint
        key = jax.random.PRNGKey(args.seed)
        t0 = time.time()
        spp_base = max(2, spp // 2)
        ckpt = AdaptiveCheckpoint(cam.height, cam.width, args.checkpoint)
        final, counts, _ = render_adaptive(
            scene, cam, key, spp_base=spp_base, rounds=4, frac=0.125,
            spp_refine=max(4, spp // 2), depth=depth,
            state=ckpt.state, on_round=ckpt.update)
        final = np.asarray(final)
        stamp = f"{int(time.time()):08X}"
        out_base = args.out or f"image{stamp}"
        bmp_io.write(out_base + ".bmp", final)
        hdr_io.write(out_base + ".hdr", final)
        counts = np.asarray(counts)
        print(f"wrote {out_base}.bmp/.hdr  adaptive spp "
              f"{counts.min():.0f}-{counts.max():.0f} "
              f"(mean {counts.mean():.1f}) in {time.time()-t0:.1f}s")
        return

    from ptx.utils.profiling import Meter, log

    acc = RenderAccumulator(cam.height, cam.width, args.checkpoint)
    done_spp = acc.samples_done if args.checkpoint else 0
    if done_spp >= spp:
        print(f"checkpoint already has {done_spp}/{spp} spp")
    key = jax.random.PRNGKey(args.seed)
    meter = Meter("render")
    dev = jax.devices()[0]
    log("render_start", width=cam.width, height=cam.height, spp=spp,
        depth=depth, resume_spp=done_spp, platform=dev.platform,
        device_kind=dev.device_kind)

    spp_step = max(1, min(spp, args.spp_chunk))
    # snap the sample chunk to a divisor of spp and the band height to a
    # divisor of H: a ragged tail chunk/band is a SECOND executable —
    # another full XLA compile (or persistent-cache load) for a few
    # percent of the work
    while spp % spp_step:
        spp_step -= 1
    rows = max(1, min(cam.height, args.rays_per_chunk // (cam.width * spp_step)))
    while cam.height % rows:
        rows -= 1
    t0 = time.time()

    if not args.checkpoint and not args.preview:
        # full-speed path: each band's ENTIRE sample loop runs as one
        # device-side fori dispatch instead of one host dispatch and one
        # (rows, W, 3) output per chunk
        # (ptx.integrate.render._render_rows_fori; same per-chunk keys as
        # the chunked path below).  Checkpoint/preview keep host
        # boundaries for durability / live updates.
        from ptx.integrate.render import _render_rows_fori
        n_chunks = spp // spp_step
        y0 = 0
        first_band_s = None
        while y0 < cam.height:
            nrows = min(rows, cam.height - y0)
            img = _render_rows_fori(scene, scene.params, cam, key,
                                    y0, nrows, spp_step, n_chunks, depth)
            acc.add(np.asarray(img), spp, y0)
            if first_band_s is None:
                # the first band pays the jit trace + persistent-cache
                # executable load (seconds) — reported separately so the
                # wall rays/s is interpretable
                first_band_s = time.time() - t0
            meter.add(rays=nrows * cam.width * spp * (depth + 1),
                      samples=nrows * cam.width * spp, tiles=1)
            y0 += nrows
            sys.stdout.write(f"\r[{y0}/{cam.height} rows] "
                             f"{time.time() - t0:.1f}s")
            sys.stdout.flush()
        print()
        final = acc.image()
        stamp = f"{int(time.time()):08X}"
        out_base = args.out or f"image{stamp}"
        bmp_io.write(out_base + ".bmp", final)
        hdr_io.write(out_base + ".hdr", final)
        rays = cam.width * cam.height * spp * (depth + 1)
        dt = time.time() - t0
        meter.emit()
        log("render_done", out=out_base, seconds=round(dt, 2),
            rays_per_sec=round(rays / max(dt, 1e-9), 1),
            first_band_s=round(first_band_s or 0.0, 2))
        print(f"wrote {out_base}.bmp/.hdr  "
              f"({rays / max(dt, 1e-9):.3g} rays/s; first band incl. "
              f"compile/load {first_band_s:.1f}s)")
        return

    s = done_spp
    while s < spp:
        cur = min(spp_step, spp - s)
        y0 = 0
        while y0 < cam.height:
            nrows = min(rows, cam.height - y0)
            k = prng.fold(key, s, y0)
            img = _render_rows(scene, scene.params, cam, k,
                               y0, nrows, cur, depth)
            acc.add(np.asarray(img), cur, y0)
            meter.add(rays=nrows * cam.width * cur * (depth + 1),
                      samples=nrows * cam.width * cur, tiles=1)
            y0 += nrows
            # row-sample units on both sides: each chunk covers cur samples
            # for every row it renders
            done = (s - done_spp) * cam.height + y0 * cur
            total = (spp - done_spp) * cam.height
            if args.preview:
                _terminal_preview(acc.image())
            else:
                sys.stdout.write(f"\r[{done}/{total} row-samples] "
                                 f"{time.time() - t0:.1f}s")
                sys.stdout.flush()
        s += cur
        if args.checkpoint:
            acc.save()
    print()

    final = acc.image()
    stamp = f"{int(time.time()):08X}"
    out_base = args.out or f"image{stamp}"
    bmp_io.write(out_base + ".bmp", final)
    hdr_io.write(out_base + ".hdr", final)
    rays = cam.width * cam.height * (spp - done_spp) * (depth + 1)
    dt = time.time() - t0
    meter.emit()
    log("render_done", out=out_base, seconds=round(dt, 2),
        rays_per_sec=round(rays / max(dt, 1e-9), 1))
    print(f"wrote {out_base}.bmp/.hdr  ({rays / max(dt, 1e-9):.3g} rays/s)")


def cmd_serve(args):
    import numpy as np
    import jax

    from ptx.integrate.render import _render_tile
    from ptx.runtime import RenderFarmServer

    scene, cam, _, _ = _build_scene(args)

    from ptx.utils.profiling import log

    def render_fn(x0, y0, w, h, spp, depth, seed):
        # render exactly the requested tile of the global camera — no
        # full-width band + crop (each tile traces only its own pixels).
        # --adaptive: the tile renders through the variance-guided
        # sampler at the SAME budget — the reference's distributed
        # rendering IS adaptive rendering (every farmed block runs the
        # recursive subdivision server-side, test.cpp:503-504,708)
        t0 = time.perf_counter()
        k = jax.random.PRNGKey(seed & 0x7FFFFFFF)
        if args.adaptive:
            from ptx.integrate.adaptive import render_adaptive_tile
            img = render_adaptive_tile(
                scene, scene.params, cam, k, int(x0), int(y0), int(w),
                int(h), int(spp), int(depth), rounds=args.adaptive_rounds,
                frac=args.adaptive_frac)
        else:
            img = _render_tile(scene, scene.params, cam, k, int(x0),
                               int(y0), int(w), int(h), int(spp),
                               int(depth))
        out = np.asarray(img)
        # per-tile structured log — the reference's per-block server couts
        # (test.cpp:704,718), machine-readable
        log("tile_done", x0=int(x0), y0=int(y0), w=int(w), h=int(h),
            spp=int(spp), adaptive=bool(args.adaptive),
            seconds=round(time.perf_counter() - t0, 3))
        return out

    srv = RenderFarmServer(render_fn, port=args.port, bind=args.bind,
                           max_inflight=args.max_inflight,
                           chunk_rows=args.chunk_rows)
    dev = jax.devices()[0]
    print(f"ptx render-farm server on :{srv.port} "
          f"(scene={args.scene or args.demo or 'demo'}, "
          f"platform={dev.platform}, device={dev.device_kind})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def cmd_farm(args):
    from ptx.io import bmp as bmp_io, hdr as hdr_io
    from ptx.runtime import RenderFarmClient

    width, height, spp, depth = _frame_settings(args)
    with RenderFarmClient(args.addresses, default_port=args.port) as cli:
        t0 = time.time()
        state = {"tiles": 0, "total_tiles": 0}

        def progress(done, total):
            state["tiles"], state["total_tiles"] = done, total

        def row_progress(rows, total_rows):
            # live intra-tile progress from streamed row bands
            sys.stdout.write(
                f"\r[{state['tiles']}/{state['total_tiles']} tiles, "
                f"{rows}/{total_rows} rows] {time.time()-t0:.1f}s")
            sys.stdout.flush()

        img = cli.render_image(width, height, tile=args.tile,
                               spp=spp, depth=depth, seed=args.seed,
                               parallel=args.parallel, progress=progress,
                               row_progress=row_progress)
    print()
    stamp = f"{int(time.time()):08X}"
    out_base = args.out or f"image{stamp}"
    bmp_io.write(out_base + ".bmp", img)
    hdr_io.write(out_base + ".hdr", img)
    print(f"wrote {out_base}.bmp/.hdr ({state['tiles']}/"
          f"{state['total_tiles']} tiles)")


def cmd_bench(args):
    import bench
    bench.main([])


def main(argv=None):
    p = argparse.ArgumentParser(prog="ptx",
                                description="differentiable CSG path tracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", help="scene spec JSON")
        sp.add_argument("--demo", choices=["demo", "config1", "config2",
                                           "config3", "config4"],
                        help="built-in scene")
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--spp", type=int, default=0)
        sp.add_argument("--depth", type=int, default=0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--out", help="output basename")

    sp = sub.add_parser("render", help="render locally")
    common(sp)
    sp.add_argument("--preview", action="store_true",
                    help="live terminal preview")
    sp.add_argument("--adaptive", action="store_true",
                    help="variance-guided adaptive sampling (the "
                         "reference's subdivision sampler, static shapes)")
    sp.add_argument("--checkpoint", help="sample-sum checkpoint (.npz)")
    # chunk-shape defaults: 65k-ray chunks (spp 1 × H/4 bands at 512²)
    sp.add_argument("--spp-chunk", type=int, default=1)
    sp.add_argument("--rays-per-chunk", type=int, default=2 ** 16)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("serve", help="render-farm worker (TCP)")
    common(sp)
    sp.add_argument("--port", type=int, default=12346)
    sp.add_argument("--bind", default="127.0.0.1",
                    help="listen address (default loopback; pass 0.0.0.0 "
                         "explicitly for farm deployments — the tile "
                         "protocol is unauthenticated)")
    sp.add_argument("--max-inflight", type=int, default=0)
    sp.add_argument("--chunk-rows", type=int, default=16,
                    help="stream tiles incrementally in row bands of this "
                         "many rows (0 = send each tile whole)")
    sp.add_argument("--adaptive", action="store_true",
                    help="render each farmed tile ADAPTIVELY at the "
                         "requested budget (base pass at spp/2, the rest "
                         "on the tile's highest-variance pixels) - the "
                         "reference's farmed blocks ARE adaptive blocks "
                         "(test.cpp:503-504,708)")
    sp.add_argument("--adaptive-rounds", type=int, default=2)
    sp.add_argument("--adaptive-frac", type=float, default=0.25)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("farm", help="farm tiles to servers")
    common(sp)
    sp.add_argument("addresses", nargs="+", help="server host[:port] list")
    sp.add_argument("--port", type=int, default=12346)
    sp.add_argument("--tile", type=int, default=64)
    sp.add_argument("--parallel", type=int, default=8)
    sp.set_defaults(fn=cmd_farm)

    sp = sub.add_parser("bench", help="headline benchmark")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.fn is not cmd_farm:
        # persistent compile cache: repeat invocations of the same shapes
        # load executables instead of recompiling
        from ptx.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
