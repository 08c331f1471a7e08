"""Bounds-masked nearest-texel image gather.

Semantics match the reference's pixel fetch: out-of-bounds lanes return
0 on every channel (/root/reference/src/image.cpp:366-396 bounds
behavior).  The index clip and bounds test are done by the caller, which
passes ``inb``.  Reverse mode is plain autodiff: the transpose of the
gather is a scatter-add of the masked cotangent into the image.
"""

from __future__ import annotations

import jax.numpy as jnp


def image_gather(img, xi, yi, inb):
    """``where(inb, img[yi, xi], 0)``.

    ``img`` (H, W, C) float32; ``xi``/``yi`` int32 of any shape, already
    clipped into range by the caller; ``inb`` bool marks lanes whose
    *unclipped* index was inside.  Differentiable w.r.t. ``img``.
    """
    return jnp.where(inb[..., None], img[yi, xi], 0.0)
