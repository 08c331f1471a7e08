"""Declarative JSON scene specification.

The reference hard-codes its world in ``makeWorld()`` with compile-time
constants (``/root/reference/src/test.cpp:31-38,107-145``); the CLI
equivalent here is a JSON document covering exactly the reference's
vocabulary (primitives C10-C11, CSG C12-C14, materials C15, textures
C16-C19, transforms C2):

```json
{
  "materials": {
    "glass": {"reflect": 0.7, "scatter": 0, "transmit": 0.9,
               "ior": 1.3, "transmit_reflect": 1},
    "sky":   {"reflect": 0, "scatter": 0,
               "emissive": {"type": "multiply", "factor": [0.01, 0.01, 0.01],
                            "child": {"type": "spherical",
                                      "child": {"type": "image",
                                                "file": "probe.hdr"}}}}
  },
  "world": {"type": "union", "objects": [
    {"type": "sphere", "center": [1, 0, -4], "radius": 0.2,
     "material": "glass"},
    {"type": "difference",
     "a": {"type": "sphere", ...}, "b": {"type": "plane", ...}},
    {"type": "transformed", "transform": {"rotate_x": 1.5708},
     "object": {...}}
  ]},
  "camera": {"width": 1920, "height": 1080, "reference_demo": true},
  "render": {"spp": 10, "depth": 16}
}
```

Texture slots accept scalars, RGB triples, or texture expression objects.
Transforms accept {"translate": [..]}, {"scale": s|[..]},
{"rotate_x|y|z": rad}, {"rotate": {"axis": [..], "angle": rad}},
{"matrix": [[..3x4..]]}, or a *list* applied left-to-right (outermost
first, matching Matrix.concat composition semantics, transform.h:391-406).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ptx.core import linalg
from ptx.geom import tape
from ptx.integrate.camera import Camera
from ptx.io import image as image_io
from ptx.shade import textures as tx
from ptx.shade.materials import Material
from ptx.utils.device import on_host


def parse_transform(spec):
    if isinstance(spec, list) and spec and isinstance(spec[0], dict):
        out = np.asarray(linalg.identity_affine())
        for s in spec:
            out = np.asarray(linalg.compose(out, parse_transform(s)))
        return out
    if "matrix" in spec:
        return np.asarray(spec["matrix"], np.float32).reshape(3, 4)
    if "translate" in spec:
        return np.asarray(linalg.translate(np.asarray(spec["translate"], np.float32)))
    if "scale" in spec:
        return np.asarray(linalg.scale(spec["scale"]))
    if "rotate_x" in spec:
        return np.asarray(linalg.rotate_x(spec["rotate_x"]))
    if "rotate_y" in spec:
        return np.asarray(linalg.rotate_y(spec["rotate_y"]))
    if "rotate_z" in spec:
        return np.asarray(linalg.rotate_z(spec["rotate_z"]))
    if "rotate" in spec:
        r = spec["rotate"]
        return np.asarray(linalg.rotate(np.asarray(r["axis"], np.float32),
                                        r["angle"]))
    raise ValueError(f"unknown transform spec {spec!r}")


class SceneSpec:
    def __init__(self, doc: dict, base_dir: str = "."):
        self.doc = doc
        self.base_dir = base_dir
        self._images: dict = {}

    @staticmethod
    def load(path) -> "SceneSpec":
        with open(path) as f:
            doc = json.load(f)
        return SceneSpec(doc, base_dir=os.path.dirname(os.path.abspath(path)))

    # -- textures ---------------------------------------------------------

    def _image(self, name):
        if name not in self._images:
            p = name if os.path.isabs(name) else os.path.join(self.base_dir, name)
            self._images[name] = image_io.load(p)
        return self._images[name]

    def parse_texture(self, spec):
        if isinstance(spec, (int, float)):
            return tx.Constant(float(spec))
        if isinstance(spec, list):
            return tx.Constant(np.asarray(spec, np.float32))
        t = spec["type"]
        if t == "constant":
            return tx.Constant(np.asarray(spec["color"], np.float32))
        if t == "image":
            return tx.ImageTex(self._image(spec["file"]),
                               alpha=spec.get("alpha", False))
        if t == "skybox":
            faces = {k: self._image(spec[k]) for k in
                     ("top", "bottom", "left", "right", "front", "back")}
            return tx.Skybox(**faces, alpha=spec.get("alpha", False))
        if t == "transformed":
            return tx.TransformedTex(parse_transform(spec["transform"]),
                                     self.parse_texture(spec["child"]))
        if t == "mirror_ball":
            return tx.MirrorBall(self.parse_texture(spec["child"]))
        if t == "spherical":
            return tx.SphericalCoords(self.parse_texture(spec["child"]))
        if t == "multiply":
            return tx.Multiply(np.asarray(spec["factor"], np.float32),
                               self.parse_texture(spec["child"]))
        if t == "log":
            return tx.Log(self.parse_texture(spec["child"]))
        raise ValueError(f"unknown texture type {t!r}")

    # -- materials --------------------------------------------------------

    def parse_material(self, spec) -> Material:
        kw = {}
        for slot in ("reflect", "scatter", "emissive", "transmit",
                     "transmit_reflect"):
            if slot in spec:
                kw[slot] = self.parse_texture(spec[slot])
        if "ior" in spec:
            kw["ior"] = float(spec["ior"])
        return Material(**kw)

    # -- objects ----------------------------------------------------------

    def parse_object(self, spec, materials):
        t = spec["type"]
        if t == "sphere":
            return tape.Sphere(np.asarray(spec["center"], np.float32),
                               float(spec["radius"]),
                               materials[spec["material"]])
        if t == "plane":
            m = materials[spec["material"]]
            n = np.asarray(spec["normal"], np.float32)
            if "point" in spec:
                return tape.Plane.from_point(n, np.asarray(spec["point"], np.float32), m)
            return tape.Plane(n, float(spec["d"]), m)
        if t == "union":
            return tape.Union(*[self.parse_object(o, materials)
                                for o in spec["objects"]])
        if t == "intersection":
            return tape.Intersection(*[self.parse_object(o, materials)
                                       for o in spec["objects"]])
        if t == "difference":
            return tape.Difference(self.parse_object(spec["a"], materials),
                                   self.parse_object(spec["b"], materials))
        if t == "transformed":
            return tape.Transformed(self.parse_object(spec["object"], materials),
                                    parse_transform(spec["transform"]))
        if t == "lens":
            from ptx.scenes.builders import make_lens
            return make_lens(spec["position"], spec["orientation"],
                             spec["radius"], spec["sphere_radius"],
                             materials[spec["material"]])
        raise ValueError(f"unknown object type {t!r}")

    # -- top level --------------------------------------------------------

    @on_host
    def build(self):
        """Returns (world, camera, render_options)."""
        materials = {name: self.parse_material(m)
                     for name, m in self.doc.get("materials", {}).items()}
        world = self.parse_object(self.doc["world"], materials)
        cam_doc = dict(self.doc.get("camera", {}))
        w = int(cam_doc.get("width", 640))
        h = int(cam_doc.get("height", 480))
        if cam_doc.get("reference_demo"):
            cam = Camera.reference_demo(w, h)
        else:
            cam = Camera(
                w, h,
                float(cam_doc.get("screen_width", 4.0 / 3.0)),
                float(cam_doc.get("screen_height", 1.0)),
                float(cam_doc.get("screen_distance", 2.0)),
                tuple(map(tuple, cam_doc["pose"])) if "pose" in cam_doc else None,
            )
        render_opts = dict(self.doc.get("render", {}))
        return world, cam, render_opts
