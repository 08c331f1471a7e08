"""Regenerate golden render images (run from repo root):
    python tests/make_goldens.py

Goldens are small fixed-seed CPU renders of the baseline scenes; the
regression test allows small numeric drift but catches semantic changes.
Regenerate deliberately when renderer semantics change intentionally.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptx.integrate.camera import Camera
from ptx.integrate.render import render
from ptx.scenes import builders
from ptx.integrate.trace import compile_scene

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

CONFIGS = {
    "config1": builders.baseline_config1,
    "config2": builders.baseline_config2,
    "config3": builders.baseline_config3,
    # config4 = HDR environment + image-textured material: the ONE
    # config exercising the image-gradient/texture-transform stack that
    # configs 1-3 never touch
    "config4": builders.baseline_config4,
}


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, fn in CONFIGS.items():
        scene = compile_scene(fn())
        cam = Camera(32, 24)
        img = np.asarray(render(scene, cam, jax.random.PRNGKey(0),
                                spp=32, depth=6))
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"{name}.npz"), img=img)
        print(name, img.shape, img.mean(axis=(0, 1)))


if __name__ == "__main__":
    main()
