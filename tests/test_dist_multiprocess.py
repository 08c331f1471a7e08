"""Real multi-process jax.distributed: two local processes (4 virtual CPU
devices each) form one 8-device global mesh via ``dist.initialize()`` (the
JAX_COORDINATOR env convention), run a sharded render and one
``make_train_step`` step, and must reproduce the single-process 8-device
results exactly — the JAX-native successor of the reference's manual
--server/--client two-host workflow (/root/reference/src/test.cpp:520-793).

This was the only multi-host-shaped code path
with zero coverage.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


@pytest.fixture(scope="module")
def single_process_digest():
    """The same workload on this process's 8-device mesh."""
    from ptx.integrate.camera import Camera
    from ptx.integrate.trace import compile_scene
    from ptx.parallel.mesh import image_sharding, make_mesh
    from ptx.parallel.render import make_train_step, render_sharded
    from ptx.scenes.builders import baseline_config1

    scene = compile_scene(baseline_config1())
    cam = Camera(16, 8)
    mesh = make_mesh(jax.devices(), tiles=4, samples=2)
    key = jax.random.PRNGKey(0)
    img = np.asarray(render_sharded(scene, cam, mesh, key, spp=4, depth=3))

    target = jax.device_put(np.zeros((cam.height, cam.width, 3), np.float32),
                            image_sharding(mesh))
    step = make_train_step(scene, cam, mesh, spp=4, depth=3)
    new_params, loss = step(scene.params, target, key)
    digest = 0.0
    for leaf in jax.tree.leaves(new_params):
        digest += float(np.sum(np.abs(np.asarray(leaf))))
    return {"loss": float(loss), "img_mean": float(img.mean()),
            "img_sum": float(img.sum()), "grad_digest": digest}


@pytest.mark.slow
def test_two_process_distributed_matches_single_process(single_process_digest):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_COORDINATOR",
                        "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "dist_worker.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed workers timed out (port/env-bound host)")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    line = next(l for l in outs[0][0].splitlines() if l.startswith("RESULT "))
    got = json.loads(line[len("RESULT "):])
    want = single_process_digest
    # same mesh shape, same device-order axis indices, same keys ⇒ the
    # distributed run computes the identical function
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["img_mean"] == pytest.approx(want["img_mean"], rel=1e-5)
    assert got["img_sum"] == pytest.approx(want["img_sum"], rel=1e-5)
    assert got["grad_digest"] == pytest.approx(want["grad_digest"], rel=1e-5)
