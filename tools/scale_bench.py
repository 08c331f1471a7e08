"""Leaf-count scaling benchmark: forward and forward+backward rays/s
vs scene size for the production first-hit strategies.

For each L: the strategy compile_scene picks (dense fold at small L,
union sweep for union-decomposable tapes, candidate-blocked otherwise),
plus the blocked path forced at small L for overhead comparison.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(n_spheres, force_blocked=False, depth=4, kind="spheres",
            sky=None, transformed=False):
    """``sky``: optional (H, W) — the stress scene's sky planes then carry
    the demo's equirect image chain (the reference's real workload class
    is big CSG *under an HDR probe*, test.cpp:123,134-140, so the union
    sweep and the sky-select machinery are measured in ONE program)."""
    import jax
    import jax.numpy as jnp
    from ptx.geom.fasthit import collect_leaves, compile_fast_hit
    from ptx.integrate.camera import Camera, sample_rays
    from ptx.integrate.trace import compile_scene, trace_rays
    from ptx.scenes.builders import (procedural_sky_image, stress_gadgets,
                                     stress_spheres)

    builder = stress_spheres if kind == "spheres" else stress_gadgets
    sky_img = procedural_sky_image(*sky) if sky else None
    kw = dict(sky_image=sky_img)
    if transformed:
        assert kind == "spheres", "--transformed is a spheres-only row"
        kw["transformed"] = True
    t0 = time.perf_counter()
    scene = compile_scene(builder(n_spheres, **kw))
    if force_blocked:
        scene.hit_fn = compile_fast_hit(scene.plan, candidate_block=32)
        scene._manual_bounce = None
    L = len(collect_leaves(scene.plan))
    cam = Camera.reference_demo(512, 512)
    key = jax.random.PRNGKey(0)
    # FULL-FRAME row subsample (every 4th row), not the top band: the
    # frame's top quarter is all sky at bounce 0, while the subsampled
    # band sees the real mix (at L=32: ~51% sky, 30% ground, 19% spheres)
    # so shading and emission run their production patterns.
    o, d = sample_rays(cam, key, jnp.arange(128) * 4, jnp.arange(512), 1)

    # ONE-DISPATCH device-side loop: host dispatch latency stays out of
    # the timed region
    iters = 20

    @jax.jit
    def wall(o):
        def body(i, o):
            r = trace_rays(scene, scene.params, o, d, key, depth)
            return o + 1e-12 * r.sum(-1, keepdims=True)
        return jax.lax.fori_loop(0, iters, body, o)

    import numpy as np
    fetch = lambda a: np.asarray(a.reshape(-1, 3)[:1, :1])  # completion
    x = wall(o)
    fetch(x)
    compile_s = time.perf_counter() - t0

    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        x = wall(x)
        fetch(x)
        dts.append(time.perf_counter() - t0)
    dt = sorted(dts)[1] / iters
    B = o[..., 0].size               # lanes, any batch shape

    # fwd+bwd, same one-dispatch loop
    dt_g = None
    if not force_blocked:
        def loss(p, o):
            r = trace_rays(scene, p, o, d, key, depth)
            return jnp.mean(r)

        giters = 12

        @jax.jit
        def gwall(o, acc):
            def body(i, c):
                o, acc = c
                v, g = jax.value_and_grad(loss)(scene.params, o)
                # keep the backward ALIVE: an unused grad pytree is
                # dead-code-eliminated wholesale (the whole VJP folds
                # away and fwd+bwd silently measures as fwd)
                gs = sum(jnp.sum(l) for l in jax.tree.leaves(g))
                return o + 1e-12 * v, acc + v + 1e-30 * gs
            return jax.lax.fori_loop(0, giters, body, (o, acc))

        acc = jnp.float32(0.0)
        x, acc = gwall(o, acc)
        assert np.isfinite(float(acc))
        dtg = []
        for _ in range(3):
            t0g = time.perf_counter()
            x, acc = gwall(x, acc)
            assert np.isfinite(float(acc))
            dtg.append(time.perf_counter() - t0g)
        dt_g = sorted(dtg)[1] / giters
    from ptx.geom import tape as _tape
    from ptx.geom.fasthit import (union_decompose, _DENSE_L_MAX,
                                  _SWEEP_GROUP_MAX, _SWEEP_L_MIN)
    groups = union_decompose(scene.plan)
    gmax = max((1 if isinstance(g, _tape._LeafPlan)
                else len(collect_leaves(g))) for g in groups)
    sweepable = (L > _SWEEP_L_MIN and len(groups) > 1
                 and gmax <= _SWEEP_GROUP_MAX)
    auto = ("sweep" if sweepable else
            "dense" if L <= _DENSE_L_MAX else "blocked")
    out = {"kind": kind, "units": n_spheres, "L": L, "depth": depth,
           "strategy": "blocked" if force_blocked else auto,
           "compile_s": round(compile_s, 1),
           "fwd_mrps": round(B * (depth + 1) / dt / 1e6, 2),
           "fwd_bwd_mrps": (round(B * (depth + 1) / dt_g / 1e6, 2)
                            if dt_g else None)}
    if sky:
        out["sky"] = f"{sky[0]}x{sky[1]}"
    if transformed:
        out["transformed"] = True
    return out


def main():
    import argparse
    from ptx.utils.compile_cache import enable_compile_cache
    from ptx.utils.device import card_info, require_gpu
    ap = argparse.ArgumentParser()
    ap.add_argument("--sky", default=None,
                    help="HxW equirect probe on the stress sky planes "
                         "(e.g. 1536x3072 — the composed workload class)")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--transformed", action="store_true",
                    help="wrap every stress sphere in a Transformed node "
                         "(per-leaf transforms)")
    ap.add_argument("--only", default=None,
                    help="comma list of unit counts to run (e.g. 249,112)")
    args = ap.parse_args()
    sky = tuple(int(v) for v in args.sky.split("x")) if args.sky else None
    only = ({int(v) for v in args.only.split(",")} if args.only else None)
    print(json.dumps({"device": require_gpu(), "card": card_info()}),
          flush=True)
    enable_compile_cache()
    cases = [(9, False, "spheres"), (9, True, "spheres"),
             (25, True, "spheres"), (57, False, "spheres"),
             (121, False, "spheres"), (249, False, "spheres"),
             (12, False, "gadgets"), (28, True, "gadgets"),
             (28, False, "gadgets"), (56, False, "gadgets"),
             (112, False, "gadgets")]
    for n, forced, kind in cases:
        if only is not None and n not in only:
            continue
        if forced and (sky or args.transformed):
            continue            # blocked-overhead rows add nothing here
        if args.transformed and kind != "spheres":
            continue
        try:
            print(json.dumps(measure(n, forced, kind=kind, sky=sky,
                                     depth=args.depth,
                                     transformed=args.transformed)),
                  flush=True)
        except Exception as e:
            print(json.dumps({"units": n, "kind": kind,
                              "error": repr(e)[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
