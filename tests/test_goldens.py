"""Golden-image regression: fixed-key renders of the baseline scenes are
deterministic (counter-based RNG, static shapes, CPU backend), so the
comparison is PIXELWISE at ~1e-5 — subtle shading regressions (a few
percent on one material) fail instead of hiding inside a statistical
tolerance.  Regenerate deliberately with tests/make_goldens.py on a
deliberate semantic change."""

import os

import numpy as np
import jax
import pytest

from ptx.integrate.camera import Camera
from ptx.integrate.render import render
from ptx.integrate.trace import compile_scene
from ptx.scenes import builders

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

CONFIGS = {
    "config1": builders.baseline_config1,
    "config2": builders.baseline_config2,
    "config3": builders.baseline_config3,
    # config4 pins the image-gradient/texture-transform stack
    "config4": builders.baseline_config4,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    want = np.load(path)["img"]
    scene = compile_scene(CONFIGS[name]())
    cam = Camera(32, 24)
    got = np.asarray(render(scene, cam, jax.random.PRNGKey(0),
                            spp=32, depth=6))
    assert got.shape == want.shape
    # exact-key determinism: pixelwise equality up to float reassociation
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                               err_msg="pixelwise golden drift")
