"""image_gather (ptx.ops.imagegrad): forward semantics and its
autodiff transpose (a scatter-add into the image) vs a scalar scatter
oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.ops import imagegrad


def _case(H=8, W=16, C=4, N=1024, seed=0):
    r = np.random.default_rng(seed)
    yi = r.integers(-2, H + 2, N).astype(np.int32)      # some out of bounds
    xi = r.integers(-2, W + 2, N).astype(np.int32)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xc = np.clip(xi, 0, W - 1)
    yc = np.clip(yi, 0, H - 1)
    vals = r.normal(size=(N, C)).astype(np.float32)
    img = r.normal(size=(H, W, C)).astype(np.float32)
    return img, xi, yi, xc, yc, inb, vals


def _scatter_oracle(H, W, C, yc, xc, inb, vals):
    out = np.zeros((H, W, C), np.float32)
    for n in range(len(yc)):
        if inb[n]:
            out[yc[n], xc[n]] += vals[n]
    return out


def test_forward_matches_masked_gather():
    img, xi, yi, xc, yc, inb, _ = _case()
    got = imagegrad.image_gather(jnp.asarray(img), jnp.asarray(xc),
                                 jnp.asarray(yc), jnp.asarray(inb))
    want = np.where(inb[:, None], img[yc, xc], 0.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=0)


def test_fallback_grad_matches_scatter_oracle():
    img, xi, yi, xc, yc, inb, vals = _case()

    def loss(im):
        out = imagegrad.image_gather(im, jnp.asarray(xc), jnp.asarray(yc),
                                     jnp.asarray(inb))
        return jnp.sum(out * jnp.asarray(vals))

    g = jax.grad(loss)(jnp.asarray(img))
    want = _scatter_oracle(*img.shape, yc, xc, inb, vals)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("H,W,C,N,seed", [
    (5, 130, 3, 2048, 3),       # W past 128, H not a multiple of 8
    (64, 128, 4, 4096, 1),
    (100, 600, 4, 2048, 5),     # sparse lanes over a wide image
    (32, 48, 3, 1000, 9),       # ragged lane count
])
def test_jit_grad_matches_scatter_oracle(H, W, C, N, seed):
    """Jitted gradient w.r.t. the image at several image/lane shapes,
    with out-of-bounds lanes masked and colliding lanes summed."""
    img, xi, yi, xc, yc, inb, vals = _case(H=H, W=W, C=C, N=N, seed=seed)

    def loss(im):
        out = imagegrad.image_gather(im, jnp.asarray(xc), jnp.asarray(yc),
                                     jnp.asarray(inb))
        return jnp.sum(out * jnp.asarray(vals))

    g = jax.jit(jax.grad(loss))(jnp.asarray(img))
    want = _scatter_oracle(*img.shape, yc, xc, inb, vals)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)
