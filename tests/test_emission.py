"""Emission through the material table (``eval_emissive``) vs the NumPy
texture oracle (tests/oracle.py ``texture``): the demo's rotated
equirect sky chain, a mirror-ball probe, mixed constant/sky material
lanes, and the gradient w.r.t. the sky image against a scatter oracle.

Positions for the exact comparisons are built by inverting the sky
chain's uv map at texel-cell centers, so a last-ulp difference between
float32 and the float64 oracle never changes the chosen texel."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from ptx.integrate import trace as tr
from ptx.scenes.builders import make_world
from ptx.shade import textures as tx
from ptx.shade.materials import assign_material_ids


def _sky(world):
    """(material id, emissive texture tree) of the scene's image sky."""
    mats, _ = assign_material_ids(world)
    for mi, m in enumerate(mats):
        if not isinstance(m.emissive, tx.Constant):
            return mi, m.emissive
    raise AssertionError("scene has no textured sky")


def _chain(tex):
    """Unwrap TransformedTex(A, Multiply(f, SphericalCoords(ImageTex)))."""
    assert isinstance(tex, tx.TransformedTex)
    mul = tex.child
    assert isinstance(mul, tx.Multiply)
    assert isinstance(mul.child, tx.SphericalCoords)
    return (np.asarray(tex.transform, np.float64).reshape(3, 4),
            np.asarray(mul.factor, np.float64), mul.child.child)


def _texel_center_positions(tex, n, seed):
    """World positions whose sky-chain uv lands at texel-cell centers;
    returns (pos, yi, xi)."""
    A, _, img_tex = _chain(tex)
    H, W = np.asarray(img_tex.image).shape[:2]
    r = np.random.default_rng(seed)
    xi = r.integers(0, W, n)
    yi = r.integers(1, H - 1, n)        # off the poles
    u = (xi + 0.5) / W
    w = 1.0 - (yi + 0.5) / H            # the image lookup flips y
    theta = (u - 0.5) * 2.0 * math.pi
    phi = (w - 0.5) * math.pi
    v = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                  np.sin(phi)], -1) * r.uniform(5.0, 50.0, (n, 1))
    pos = (v - A[:, 3]) @ np.linalg.inv(A[:, :3]).T
    return pos.astype(np.float32), yi, xi


@pytest.fixture(scope="module")
def demo():
    world = make_world()
    return world, tr.compile_scene(world)


def test_demo_sky_chain_matches_oracle(demo):
    world, scene = demo
    sky_id, tex = _sky(world)
    pos, _, _ = _texel_center_positions(tex, 1024, seed=0)
    mid = jnp.full((1024,), sky_id, jnp.int32)
    got = jax.jit(scene.material_fn.eval_emissive)(
        scene.params, jnp.asarray(pos), mid)
    want = oracle.texture(tex, pos)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_mixed_material_lanes_match_oracle(demo):
    """Random material ids: constant-emission lanes read their constant,
    sky lanes the image chain."""
    world, scene = demo
    mats, _ = assign_material_ids(world)
    sky_id, tex = _sky(world)
    pos, _, _ = _texel_center_positions(tex, 1024, seed=1)
    r = np.random.default_rng(2)
    mid = r.integers(0, len(mats), 1024).astype(np.int32)
    got = np.asarray(jax.jit(scene.material_fn.eval_emissive)(
        scene.params, jnp.asarray(pos), jnp.asarray(mid)))
    want = np.stack([oracle.texture(mats[m].emissive, pos[i:i + 1])[0]
                     for i, m in enumerate(mid)])
    assert (mid == sky_id).any() and (mid != sky_id).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mirror_ball_chain_matches_oracle():
    """A mirror-ball probe sky (the demo only exercises the equirect
    map): random directions, texel-boundary flips bounded."""
    from ptx.geom.tape import Sphere
    from ptx.scenes.builders import (Material, make_sky_mirror_sphere,
                                     sky_planes, union_array)

    r = np.random.default_rng(7)
    probe = r.uniform(0.0, 2.0, (16, 32, 4)).astype(np.float32)
    sky = make_sky_mirror_sphere(probe, scale=(1.5, 1.0, 0.5))
    world = union_array([Sphere((0.0, 0.0, -4.0), 1.0,
                                Material(reflect=0.8, scatter=1.0))]
                        + sky_planes(sky))
    scene = tr.compile_scene(world)
    sky_id, tex = _sky(world)
    d = (r.normal(size=(1024, 3)) * 20.0).astype(np.float32)
    got = np.asarray(jax.jit(scene.material_fn.eval_emissive)(
        scene.params, jnp.asarray(d), jnp.full((1024,), sky_id, jnp.int32)))
    want = oracle.texture(tex, d)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=-1)
    # a direction within ~1e-7 of a texel boundary may round either way
    assert close.mean() > 0.995, float(close.mean())


def test_sky_image_gradient_matches_scatter_oracle(demo):
    """d(Σ w · emission)/d(sky image): each lane adds w · factor into the
    texel its chain selects (out-of-bounds lanes nowhere)."""
    world, scene = demo
    sky_id, tex = _sky(world)
    _, factor, img_tex = _chain(tex)
    pos, yi, xi = _texel_center_positions(tex, 2048, seed=3)
    r = np.random.default_rng(4)
    wgt = r.uniform(0.2, 1.0, (2048, 3)).astype(np.float32)
    mid = jnp.full((2048,), sky_id, jnp.int32)

    def loss(images):
        p = {**scene.params, "images": images}
        return jnp.sum(scene.material_fn.eval_emissive(
            p, jnp.asarray(pos), mid) * wgt)

    g = jax.jit(jax.grad(loss))(scene.params["images"])
    img = np.asarray(img_tex.image)
    img_id = [i for i, a in enumerate(scene.params["images"])
              if a.shape == img.shape and np.array_equal(np.asarray(a), img)]
    assert len(img_id) == 1
    want = np.zeros(img.shape, np.float64)
    np.add.at(want, (yi, xi, slice(0, 3)), wgt * factor)
    np.testing.assert_allclose(np.asarray(g[img_id[0]]), want,
                               rtol=1e-5, atol=1e-9)
    for k, a in enumerate(g):
        if k != img_id[0]:
            assert not np.asarray(a).any()
