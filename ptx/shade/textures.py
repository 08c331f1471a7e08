"""Procedural / image texture system, compiled to batched gather kernels.

The reference's textures are virtual-dispatch trees evaluated per shading
point (``/root/reference/include/texture.h``, ``image_texture.h``,
``transform_texture.h``, ``filter_texture.h``).  Here each texture
*expression tree* compiles to a closure ``fn(params, pos) -> (..., 3)``
whose numeric leaves (constant colors, multiply factors, transform
matrices, image arrays) live in the params pytree — so pixel gradients
flow into texture parameters, the BASELINE differentiability target.

Scalar lookups (`getFloat`) are the channel mean of the color lookup
(texture.h:14-18); alpha textures already return ``Color(alpha)`` so the
mean reproduces the reference for every type.

Lookup semantics reproduced exactly:

- :class:`ImageTex`: wrap via ``x − floor(x)``, y flipped *before* scaling
  (so an integral pos.y lands on row H → out of bounds → black),
  nearest-neighbor, out-of-bounds reads return black
  (image_texture.h:18-28, image.cpp:366-380).
- :class:`Skybox`: 6-face cubemap selected by dominant axis with the
  reference's exact face orientations (image_texture.h:90-110).
- :class:`MirrorBall` / :class:`SphericalCoords`: angular-probe and
  equirect direction→uv maps (transform_texture.h:46-59, 73-85).
- :class:`Multiply` / :class:`Log`: post-filters (filter_texture.h:30-73).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax.numpy as jnp

from ptx.core import linalg


# ---------------------------------------------------------------------------
# expression tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Constant:
    color: Any                  # scalar or (3,)


@dataclasses.dataclass(frozen=True)
class ImageTex:
    image: Any                  # (H, W, 4) float32 RGBA
    alpha: bool = False         # ImageAlphaTexture (image_texture.h:35-70)


@dataclasses.dataclass(frozen=True)
class Skybox:
    top: Any; bottom: Any; left: Any; right: Any; front: Any; back: Any
    alpha: bool = False


@dataclasses.dataclass(frozen=True)
class TransformedTex:
    """Looks up the child at ``A · pos`` (texture.h:60-90)."""
    transform: Any              # (3, 4)
    child: Any


@dataclasses.dataclass(frozen=True)
class MirrorBall:
    child: Any


@dataclasses.dataclass(frozen=True)
class SphericalCoords:
    child: Any


@dataclasses.dataclass(frozen=True)
class Multiply:
    factor: Any                 # scalar or (3,)
    child: Any


@dataclasses.dataclass(frozen=True)
class Log:
    child: Any


def transform_texture(A, tex):
    """The reference's free ``transform(m, Texture*)`` (texture.h:92-98):
    wrap in a lookup-position transform; constants are transform-invariant;
    an existing TransformedTex chains (``m.concat(rt)`` = argument applied
    first, texture.h:86-89)."""
    if isinstance(tex, Constant):
        return tex
    if isinstance(tex, TransformedTex):
        return TransformedTex(
            np.asarray(linalg.compose(jnp.asarray(tex.transform), jnp.asarray(A))),
            tex.child)
    return TransformedTex(A, tex)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

class TextureCompiler:
    """Assigns param slots for texture leaves; one instance per scene."""

    def __init__(self):
        self.params: dict = {"const": [], "factor": [], "tex_xform": []}
        self.images: list = []           # list of (H, W, 4) arrays
        self._image_ids: dict = {}       # id(array) -> index

    def _image_id(self, img) -> int:
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None].repeat(4, axis=-1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
        key = id(img)
        if key not in self._image_ids:
            self._image_ids[key] = len(self.images)
            self.images.append(arr)
        return self._image_ids[key]

    def compile(self, tex):
        """Returns ``fn(params, pos) -> (..., 3)``."""
        if isinstance(tex, Constant):
            idx = len(self.params["const"])
            self.params["const"].append(
                np.broadcast_to(np.asarray(tex.color, np.float32), (3,)).copy())
            return lambda p, pos: jnp.broadcast_to(p["const"][idx], pos.shape)

        if isinstance(tex, ImageTex):
            img_id = self._image_id(tex.image)
            alpha = tex.alpha

            def image_fn(p, pos):
                img = p["images"][img_id]
                h, w = img.shape[0], img.shape[1]
                x = pos[..., 0] - jnp.floor(pos[..., 0])
                y = pos[..., 1] - jnp.floor(pos[..., 1])
                y = 1.0 - y
                xi = jnp.floor(x * w).astype(jnp.int32)
                yi = jnp.floor(y * h).astype(jnp.int32)
                return _get_pixel(img, xi, yi, alpha)
            return image_fn

        if isinstance(tex, Skybox):
            faces = [tex.top, tex.bottom, tex.left, tex.right, tex.front, tex.back]
            ids = [self._image_id(f) for f in faces]
            shapes = {self.images[i].shape for i in ids}
            if len(shapes) != 1:
                raise ValueError("skybox faces must share dimensions")
            alpha = tex.alpha

            def skybox_fn(p, pos):
                stack = jnp.stack([p["images"][i] for i in ids])  # (6, H, W, 4)
                return _skybox_lookup(stack, pos, alpha)
            return skybox_fn

        if isinstance(tex, TransformedTex):
            idx = len(self.params["tex_xform"])
            self.params["tex_xform"].append(
                np.asarray(tex.transform, np.float32).reshape(3, 4))
            child = self.compile(tex.child)
            return lambda p, pos: child(p, linalg.apply(p["tex_xform"][idx], pos))

        if isinstance(tex, MirrorBall):
            child = self.compile(tex.child)
            return lambda p, pos: child(p, _mirror_ball_uv(pos))

        if isinstance(tex, SphericalCoords):
            child = self.compile(tex.child)
            return lambda p, pos: child(p, _spherical_uv(pos))

        if isinstance(tex, Multiply):
            idx = len(self.params["factor"])
            self.params["factor"].append(
                np.broadcast_to(np.asarray(tex.factor, np.float32), (3,)).copy())
            child = self.compile(tex.child)
            return lambda p, pos: child(p, pos) * p["factor"][idx]

        if isinstance(tex, Log):
            child = self.compile(tex.child)

            def log_fn(p, pos):
                v = child(p, pos)
                safe = jnp.maximum(v, 1e-30)
                return jnp.where(v <= 1e-30, 0.0,
                                 0.5 + jnp.log2(safe) / 256.0)
            return log_fn

        raise TypeError(f"unknown texture node {type(tex)!r}")

    def finalize(self) -> dict:
        """Produce the jnp params-dict contribution."""
        return {
            "const": jnp.asarray(np.array(self.params["const"], np.float32).reshape(-1, 3)),
            "factor": jnp.asarray(np.array(self.params["factor"], np.float32).reshape(-1, 3)),
            "tex_xform": jnp.asarray(np.array(self.params["tex_xform"], np.float32).reshape(-1, 3, 4)),
            "images": [jnp.asarray(img) for img in self.images],
        }


# ---------------------------------------------------------------------------
# texel lookups
# ---------------------------------------------------------------------------

def _get_pixel(img, xi, yi, alpha: bool):
    """Bounds-checked nearest lookup; outside → black / alpha 0
    (image.cpp:366-396).  Returns (..., 3); alpha broadcast to gray.

    The gather goes through ptx.ops.imagegrad.image_gather (one masked
    gather; its transpose is a scatter-add into the image)."""
    from ptx.ops.imagegrad import image_gather

    h, w = img.shape[0], img.shape[1]
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xc = jnp.clip(xi, 0, w - 1)
    yc = jnp.clip(yi, 0, h - 1)
    texel = image_gather(img, xc, yc, inb)   # (..., 4) masked gather
    val = texel[..., 3:4] if alpha else texel[..., :3]
    return jnp.broadcast_to(val, val.shape[:-1] + (3,))


def _skybox_face_uv(v):
    """Dominant-axis face index + the reference's per-face (x, y)
    (image_texture.h:90-110).  Faces: 0 top, 1 bottom, 2 left, 3 right,
    4 front, 5 back."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    x_dom = (ax > ay) & (ax > az)
    y_dom = ~x_dom & (ay > az)
    z_dom = ~x_dom & ~y_dom

    safe = lambda d: jnp.where(d == 0, 1.0, d)
    face = jnp.where(
        x_dom, jnp.where(x < 0, 2, 3),
        jnp.where(y_dom, jnp.where(y < 0, 1, 0), jnp.where(z < 0, 5, 4)))
    u = jnp.where(
        x_dom, jnp.where(x < 0, -z, z) / safe(ax),
        jnp.where(y_dom, jnp.where(y < 0, -x, x) / safe(ay),
                  jnp.where(z < 0, x, -x) / safe(az)))
    w = jnp.where(
        x_dom, y / safe(ax),
        jnp.where(y_dom, z / safe(ay), y / safe(az)))
    return face.astype(jnp.int32), u, w


def _skybox_lookup(stack, v, alpha: bool):
    zero_dir = jnp.all(v == 0.0, axis=-1)
    face, u, w = _skybox_face_uv(v)
    h, wid = stack.shape[1], stack.shape[2]
    x = (u * 0.5 + 0.5) * wid
    y = (0.5 - w * 0.5) * h
    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    inb = (xi >= 0) & (xi < wid) & (yi >= 0) & (yi < h)
    xc = jnp.clip(xi, 0, wid - 1)
    yc = jnp.clip(yi, 0, h - 1)
    # fold the face index into the row index so the 6-face lookup is one
    # image_gather (stack viewed as (6·H, W, 4))
    from ptx.ops.imagegrad import image_gather
    flat = stack.reshape(6 * h, wid, stack.shape[3])
    texel = image_gather(flat, xc, face * h + yc, inb & ~zero_dir)
    val = texel[..., 3:4] if alpha else texel[..., :3]
    return jnp.broadcast_to(val, val.shape[:-1] + (3,))


def _mirror_ball_uv(v):
    """Angular mirror-ball probe mapping (transform_texture.h:46-59)."""
    zero = jnp.all(v == 0.0, axis=-1)
    n = linalg.normalize(v)
    z = n[..., 2]
    d = jnp.sqrt(jnp.maximum(2.0 + 2.0 * z, 0.0))
    bad = (z <= -1.0) | (d == 0.0)
    safe_d = jnp.where(bad, 1.0, d)
    u = n[..., 0] / safe_d * 0.5 + 0.5
    w = n[..., 1] / safe_d * 0.5 + 0.5
    u = jnp.where(bad, 0.0, u)
    w = jnp.where(bad, 0.5, w)
    u = jnp.where(zero, 0.0, u)
    w = jnp.where(zero, 0.0, w)
    return jnp.stack([u, w, jnp.zeros_like(u)], axis=-1)


def _spherical_uv(v):
    """Equirect lat-long mapping (transform_texture.h:73-85)."""
    zero = jnp.all(v == 0.0, axis=-1)
    n = linalg.normalize(v)
    theta = jnp.arctan2(n[..., 1], n[..., 0])
    phi = jnp.arcsin(jnp.clip(n[..., 2], -1.0, 1.0))
    u = theta * 0.5 / jnp.pi + 0.5
    w = phi / (jnp.pi / 2.0) * 0.5 + 0.5
    u = jnp.where(zero, 0.0, u)
    w = jnp.where(zero, 0.0, w)
    return jnp.stack([u, w, jnp.zeros_like(u)], axis=-1)
