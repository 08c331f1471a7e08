"""Golden parity harness: ptx vs the ACTUAL reference binary, low noise.

Builds the reference from source in SERVER_ONLY mode (no SDL) with three
noise-removal patches:

- ``rayCount`` 10 → 100 (test.cpp:34) — the reference's own samples;
- ``minimumColorDelta`` → 0 and ``maximumSampleSize`` → 1
  (test.cpp:38,50) — adaptive bilinear interpolation OFF, so every
  compared pixel was actually traced by the reference;

then serves it on localhost, drives its ASCII block protocol (several
blocks in parallel — the diffuse regions are slow: the 10000-child
scatter fan-out, path-trace.h:130), renders the identical pixels with ptx
at high spp (accumulated chunks), and compares PER-PIXEL.

Pass criterion: median per-pixel relative error ≤ 3% on every block
(combined MC error of ref@100spp-with-fanout and ptx@high-spp).
Results belong in BASELINE.md ("Golden parity").

Usage (needs g++, libpng headers; ~30-60 min dominated by the reference's
diffuse blocks):
    python tools/parity_vs_reference.py [--workdir .work/refbuild]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF = "/root/reference"

# (x, y, size) with measured screen projections (camera: screen=pixel
# dims at distance 2·1080, so px = 960·(1 − 1.125·X/Z)): glass bulb
# (unit sphere at (1,0,−4)) → disc r≈270 px at (1230, 540); its emissive
# core and inner diffuse sphere (r 0.2) → r≈54 px at (1230, 540); the
# lens (r 0.5 at (−0.625,0,−2.5)) → r≈216 px at (690, 540); the diffuse
# sphere (r 0.2 at (−1,0,−4)) → r≈54 px at (690, 540) — entirely BEHIND
# the lens disc, visible only through it.  Pure-sky blocks compare
# exactly (nearest-texel sky lookups are jitter-invariant at this
# resolution — both renderers return the identical texel): they validate
# the sky texture stack bit-level, not the integrator.  The
# diffuse-through-lens block is the slow one: the reference's
# 10000-child scatter fan-out renders it at ~1 px/s/thread.
BLOCKS = [
    (64, 64, 64),       # sky corner (deterministic-texel control)
    (1600, 200, 64),    # sky right (deterministic-texel control)
    (300, 900, 48),     # sky bottom (deterministic-texel control)
    (1176, 486, 64),    # glass bulb interior + emissive core
    (944, 524, 32),     # glass bulb rim vs sky
    (560, 524, 32),     # lens-refracted sky
    (674, 524, 32),     # diffuse sphere seen through the lens (hard)
]


def build_reference(workdir: str) -> str:
    os.makedirs(workdir, exist_ok=True)
    for d in ("src", "include"):
        shutil.copytree(os.path.join(REF, d), os.path.join(workdir, d),
                        dirs_exist_ok=True)
    # shims for libpng>=1.5 (the reference targets 1.2-era macros)
    pd = os.path.join(workdir, "src", "png_decoder.cpp")
    s = open(pd).read()
    if "#include <cstring>" not in s:
        s = "#include <cstring>\n" + s
    s = (s.replace("png_infopp_NULL", "(png_infopp)NULL")
          .replace("int_p_NULL", "(int*)NULL")
          .replace("png_voidp_NULL", "(png_voidp)NULL"))
    open(pd, "w").write(s)

    # low-noise patches (see module docstring)
    tc = os.path.join(workdir, "src", "test.cpp")
    s = open(tc).read()
    pairs = [
        ("const int rayCount = 10;", "const int rayCount = 100;"),
        ("const float minimumColorDelta = 0.003;",
         "const float minimumColorDelta = 0;"),
        ("maximumSampleSize = ScreenHeight / (480 / 4);",
         "maximumSampleSize = 1;"),
    ]
    for old, new in pairs:
        assert old in s, f"reference source drifted: {old!r} not found"
        s = s.replace(old, new)
    open(tc, "w").write(s)

    out = os.path.join(workdir, "ref-server")
    subprocess.run(
        ["g++", "-O3", "-DSERVER_ONLY", "-Iinclude"]
        + sorted(os.path.join("src", f) for f in os.listdir(
            os.path.join(workdir, "src")) if f.endswith(".cpp"))
        + ["-o", "ref-server", "-lpng", "-lpthread", "-lrt"],
        cwd=workdir, check=True)
    # assets: demo scene loads these from cwd at static init
    for a in ("test.hdr", "test2.hdr"):
        shutil.copy(os.path.join(REF, a), workdir)
    from ptx.scenes.builders import procedural_sky_image
    from ptx.io import hdr
    sky_path = os.path.join(workdir, "Serpentine_Valley_3k.hdr")
    # ALWAYS regenerate: a stale file from an older builders version
    # silently changes the scene for both renderers (cost one dark-sky
    # parity run to learn)
    hdr.write(sky_path, procedural_sky_image(1536, 3072)[..., :3])
    return out


def fetch_block(x, y, size, port=12346, timeout=7200):
    buf = np.full((size + 1, size + 1, 3), np.nan, np.float32)
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
        except OSError:
            time.sleep(1)
            continue
        f = s.makefile("rwb")
        if f.readline().strip() != b"1":
            s.close()
            time.sleep(2)
            continue
        f.write(f"{x} {y} {size}\n".encode())
        f.flush()
        while True:
            line = f.readline()
            if not line:
                break
            c = line[:1]
            if c == b"P":
                coord, _, rgb = line[1:].strip().decode().partition("=")
                px, py = map(int, coord.split(","))
                buf[py - y, px - x] = tuple(map(float, rgb.split(",")))
            elif c == b"F":
                s.close()
                return buf
        s.close()
        time.sleep(1)
    return buf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".work", "refbuild"))
    ap.add_argument("--spp", type=int, default=4096,
                    help="total ptx samples per pixel (accumulated). The "
                    "single-path estimator needs ~4k spp for <=2-3%% "
                    "per-pixel SEM on diffuse-through-lens pixels; the "
                    "reference's estimator (deterministic glass branches "
                    "+ scatter fan-out) converges much faster per sample")
    ap.add_argument("--spp-chunk", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.03)
    args = ap.parse_args()

    # fail fast if a stale server holds the port: our Popen'd server
    # would silently fail to bind and every block would come from a
    # process with a DIFFERENT scene (cost one wasted parity run to learn)
    probe = socket.socket()
    try:
        probe.bind(("127.0.0.1", 12346))
    except OSError:
        print("ERROR: port 12346 already bound — kill the stale "
              "ref-server first (ss -tlnp | grep 12346)", file=sys.stderr)
        return 2
    finally:
        probe.close()

    build_reference(args.workdir)
    srv = subprocess.Popen(["./ref-server"], cwd=args.workdir,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    try:
        import jax
        import jax.numpy as jnp
        from ptx.core import rng as prng
        from ptx.integrate.camera import Camera
        from ptx.integrate.render import _render_tile
        from ptx.integrate.trace import compile_scene
        from ptx.io import hdr
        from ptx.scenes.builders import make_world

        sky = hdr.read(os.path.join(args.workdir,
                                    "Serpentine_Valley_3k.hdr"))
        scene = compile_scene(make_world(sky_image=sky))
        cam = Camera.reference_demo(1920, 1080)
        key = jax.random.PRNGKey(3)

        # reference blocks render in parallel while ptx renders on-chip.
        # Results are cached on disk (keyed by block + the patched config):
        # the diffuse blocks cost ~1 h of reference CPU; the cache makes
        # ptx-side iteration (spp, estimator changes) minutes instead.
        cache_tag = "r100_nointerp_v1"

        def fetch_cached(x, y, sz):
            path = os.path.join(args.workdir,
                                f"refblk_{cache_tag}_{x}_{y}_{sz}.npy")
            if os.path.exists(path):
                return np.load(path)
            blk = fetch_block(x, y, sz)
            if np.isfinite(blk[:sz, :sz]).all():
                np.save(path, blk)
            return blk

        pool = cf.ThreadPoolExecutor(4)
        futs = {pool.submit(fetch_cached, x, y, sz): (x, y, sz)
                for x, y, sz in BLOCKS}

        ptx_blocks = {}
        for x, y, sz in BLOCKS:
            acc = None
            chunks = max(1, args.spp // args.spp_chunk)
            for i in range(chunks):
                # compact=False: per-pixel parity needs the exact
                # estimator — compaction's overflow resampling is an
                # (unbiased, separately tested) per-pixel variance source
                img = _render_tile(scene, scene.params, cam,
                                   prng.fold(key, x, y, i),
                                   jnp.int32(x), jnp.int32(y), sz, sz,
                                   args.spp_chunk, 16, compact=False)
                acc = img if acc is None else acc + img
            ptx_blocks[(x, y, sz)] = np.asarray(acc) / chunks
        print(json.dumps({"event": "ptx_blocks_done"}), flush=True)

        def metrics(ptx_blk, ref_blk):
            valid = np.isfinite(ref_blk[..., 0])
            diff = np.abs(ptx_blk - ref_blk)[valid]
            rel = (np.abs(ptx_blk - ref_blk)
                   / (np.abs(ref_blk) + 1e-3))[valid]
            return (valid, float(np.median(rel)), float(np.median(diff)),
                    float(np.percentile(rel, 90)))

        all_pass = True
        worst = 0.0
        for fut in cf.as_completed(futs):
            x, y, sz = futs[fut]
            ref_blk = fut.result()[:sz, :sz]
            ptx_blk = ptx_blocks[(x, y, sz)]
            valid, med, med_abs, p90 = metrics(ptx_blk, ref_blk)
            # pass: relative agreement where there is signal, OR absolute
            # agreement below one 8-bit step (1/256 — the reference's own
            # output medium, test.cpp:993-995) in near-black regions
            ok = med <= args.threshold or med_abs <= 1.0 / 256.0
            r = {"block": [x, y, sz], "traced_px": int(valid.sum()),
                 "median_relerr": round(med, 4),
                 "median_abserr": round(med_abs, 5),
                 "p90_relerr": round(p90, 4),
                 "ref_mean": round(float(np.nanmean(ref_blk)), 4),
                 "ptx_mean": round(float(ptx_blk.mean()), 4),
                 "pass": bool(ok)}
            if not ok:
                # Noise-aware retry: in caustic/TIR bands (lens rim) the
                # angular magnification diverges and the REFERENCE itself
                # is MC-noise-dominated at rayCount=100 — per-pixel error
                # vs one noisy draw says nothing.  The reference's racy
                # shared LCG (path-trace.h:56, SURVEY C6) makes a repeat
                # render an INDEPENDENT draw, so ref-vs-ref error
                # calibrates its own noise floor; require ptx to agree
                # with ref no worse than ref agrees with itself.
                path2 = os.path.join(
                    args.workdir, f"refblk_{cache_tag}_{x}_{y}_{sz}_b.npy")
                if os.path.exists(path2):
                    ref2 = np.load(path2)
                else:
                    ref2 = fetch_block(x, y, sz)
                    if np.isfinite(ref2[:sz, :sz]).all():
                        np.save(path2, ref2)
                ref2 = ref2[:sz, :sz]
                _, self_med, _, _ = metrics(ref2, ref_blk)
                ok = med <= max(args.threshold, 1.2 * self_med)
                r["ref_self_median_relerr"] = round(self_med, 4)
                r["pass"] = bool(ok)
            all_pass &= ok
            worst = max(worst, med if not ok else 0.0)
            print(json.dumps(r), flush=True)
        pool.shutdown()
        print(json.dumps({"threshold": args.threshold,
                          "pass": bool(all_pass)}), flush=True)
        return 0 if all_pass else 1
    finally:
        srv.terminate()
        srv.wait()


if __name__ == "__main__":
    raise SystemExit(main())
