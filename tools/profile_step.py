"""Profile the bench chunk with jax.profiler and decode the trace into a
top-ops table; also the one trace reader the other tools use.

Device time is read from the GPU's stream lines of the perfetto trace
that ``jax.profiler`` writes (``create_perfetto_trace=True``): each
kernel, copy and memset the card ran is one interval there.  Busy time
is the union of those intervals; the top-ops table sums each op's own.
GPU kernel events carry no source-line metadata, so ops are listed by
kernel name.

Usage: python tools/profile_step.py [fwd|grad] [iters] [skyHxW]
e.g. python tools/profile_step.py grad 6 sky1536x3072
"""

import glob
import gzip
import json
import os
import shutil
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_events(logdir):
    """The complete ("X") events on the GPU stream lines of the newest
    perfetto trace under ``logdir``, and the names of those lines."""
    path = max(glob.glob(os.path.join(logdir, "**", "perfetto_trace.json.gz"),
                         recursive=True), key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    pnames, tnames = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e["tid"])] = e["args"].get("name", "")
    dev = {p for p, n in pnames.items() if "gpu" in n.lower()
           and "host" not in n.lower()}
    lines = {k for k in tnames if k[0] in dev
             and "stream" in tnames[k].lower()}
    evs = [e for e in events if e.get("ph") == "X" and "dur" in e
           and (e["pid"], e["tid"]) in lines]
    return evs, sorted({tnames[k] for k in lines})


def busy_us(events):
    """Union of the events' intervals, in µs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def run(mode="grad", iters=6, logdir=os.path.join(ROOT, ".work", "profile"),
        sky=None):
    import jax
    import jax.numpy as jnp

    from ptx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from ptx.core import rng as prng
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.integrate.trace import compile_scene, trace_rays
    from ptx.scenes.builders import make_world, procedural_sky_image

    width = height = 512
    depth = 16
    # bench.py's chunk shape: H/4 (65k-ray chunks) on the demo, H/2 for
    # big-probe variants
    rows = height // (2 if sky else 4)
    sky_img = procedural_sky_image(*sky) if sky else None
    scene = compile_scene(make_world(sky_image=sky_img))
    cam = Camera.reference_demo(width, height)
    key = jax.random.PRNGKey(0)

    def chunk_loss(params, key, i):
        key = prng.fold(key, i)
        ys = jnp.arange(rows)
        o, d = sample_rays(cam, key, ys, jnp.arange(width), 1)
        radiance = trace_rays(scene, params, o, d, key, depth, remat=False)
        return jnp.mean(radiance)

    fn = jax.jit(jax.value_and_grad(chunk_loss) if mode == "grad"
                 else chunk_loss)
    out = fn(scene.params, key, jnp.int32(0))
    jax.block_until_ready(out)

    shutil.rmtree(logdir, ignore_errors=True)
    with jax.profiler.trace(logdir, create_perfetto_trace=True):
        for i in range(iters):
            out = fn(scene.params, key, jnp.int32(i))
        jax.block_until_ready(out)
    return logdir, iters


def decode(logdir, iters, top=30):
    """Print device busy time per iteration and the ``top`` ops by
    their summed time."""
    events, lines = device_events(logdir)
    dur_by_name = defaultdict(float)
    cnt_by_name = defaultdict(int)
    for e in events:
        dur_by_name[e.get("name", "?")] += e["dur"]
        cnt_by_name[e.get("name", "?")] += 1
    print(f"device busy: {busy_us(events) / 1e3 / iters:.3f} ms/iter "
          f"({len(dur_by_name)} distinct ops on {', '.join(lines)})")
    for name, d in sorted(dur_by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{d / 1e3 / iters:8.3f} ms  x{cnt_by_name[name] // iters:<4d}"
              f" {name[:100]}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "grad"
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    sky = None
    if len(sys.argv) > 3 and sys.argv[3].startswith("sky"):
        sky = tuple(int(v) for v in sys.argv[3][3:].split("x"))
    logdir, iters = run(mode, iters, sky=sky)
    decode(logdir, iters)
