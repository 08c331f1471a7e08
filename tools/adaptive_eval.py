"""Equal-ray-budget dense vs adaptive comparison at the reference's full
frame config (1920×1080, demo scene).

Ground truth = dense render at ``truth_spp``.  Dense candidate = uniform
``budget`` spp.  Adaptive candidate = same total ray budget, concentrated
by variance ranking (ptx.integrate.adaptive).  Prints JSON lines with
RMSE of each against truth; adaptive should win at equal budget.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import jax

    from ptx.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from ptx.core import rng
    from ptx.integrate.adaptive import render_adaptive
    from ptx.integrate.camera import Camera
    from ptx.integrate.render import render
    from ptx.integrate.trace import compile_scene
    from ptx.scenes.builders import make_world

    width, height = 1920, 1080
    depth = 16
    budget = 16          # average spp for both candidates
    truth_spp = 64

    scene = compile_scene(make_world())
    cam = Camera.reference_demo(width, height)
    key = jax.random.PRNGKey(0)

    def timed_render(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        out = np.asarray(out)
        dt = time.perf_counter() - t0
        print(json.dumps({"stage": tag, "seconds": round(dt, 1)}),
              flush=True)
        return out

    truth = timed_render("truth_dense_%dspp" % truth_spp, lambda: render(
        scene, cam, rng.fold(key, 999), spp=truth_spp, depth=depth,
        rays_per_chunk=2 ** 21))

    dense = timed_render("dense_%dspp" % budget, lambda: render(
        scene, cam, rng.fold(key, 1), spp=budget, depth=depth,
        rays_per_chunk=2 ** 21))

    # adaptive: base 8 spp everywhere + 4 rounds × 1/8 of pixels × 16 spp
    # = 8 + 4·2 = 16 average spp — the same ray budget as dense.
    # Runs THROUGH the durable checkpoint path: every
    # round lands in AdaptiveCheckpoint, and the result is re-derived by
    # resuming from the round-2 snapshot to prove resume ≡ uninterrupted
    # at full frame scale.
    from ptx.parallel.checkpoint import AdaptiveCheckpoint
    ck_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".work")
    os.makedirs(ck_dir, exist_ok=True)
    ck_path = os.path.join(ck_dir, "adaptive_eval_ck.npz")
    if os.path.exists(ck_path):
        os.remove(ck_path)
    snapshots = {}

    def run_adaptive():
        ck = AdaptiveCheckpoint(height, width, ck_path)

        def hook(s1, s2, count, r):
            ck.update(s1, s2, count, r)
            if r == 2:
                snapshots[2] = (np.asarray(s1), np.asarray(s2),
                                np.asarray(count), 2)
        img, counts, _ = render_adaptive(
            scene, cam, rng.fold(key, 2), spp_base=8, rounds=4,
            frac=0.125, spp_refine=16, depth=depth, on_round=hook)
        run_adaptive.counts = np.asarray(counts)
        return img

    adap = timed_render("adaptive_equal_budget", run_adaptive)
    counts = run_adaptive.counts

    # resume from the round-2 snapshot: must equal the straight run
    img_res, counts_res, _ = render_adaptive(
        scene, cam, rng.fold(key, 2), spp_base=8, rounds=4,
        frac=0.125, spp_refine=16, depth=depth, state=snapshots[2])
    resume_ok = bool(np.allclose(np.asarray(img_res), adap,
                                 rtol=1e-5, atol=1e-6))
    print(json.dumps({"stage": "checkpoint_resume_equals_straight",
                      "ok": resume_ok}), flush=True)

    rmse = lambda a: float(np.sqrt(np.mean((a - truth) ** 2)))
    result = {
        "frame": [width, height], "depth": depth,
        "budget_spp": budget, "truth_spp": truth_spp,
        "dense_rmse": round(rmse(dense), 5),
        "adaptive_rmse": round(rmse(adap), 5),
        "adaptive_mean_spp": round(float(counts.mean()), 2),
        "adaptive_max_spp": float(counts.max()),
        "adaptive_wins": rmse(adap) < rmse(dense),
        "checkpoint_resume_ok": resume_ok,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
