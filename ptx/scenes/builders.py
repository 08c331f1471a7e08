"""Scene construction helpers + the demo/benchmark scenes.

Re-creations of the reference driver's scene vocabulary
(``/root/reference/src/test.cpp:52-145``): the balanced ``unionArray`` (its
n-ary collapse happens in the tape compiler), the CSG lens builders, the
sky helpers (cubemap box / mirror-ball probe / equirect probe), and
``make_world`` — the committed demo scene.  BASELINE config scenes #1-#4
live here too.
"""

from __future__ import annotations

import math

import numpy as np

from ptx.core import linalg
from ptx.core.constants import EPS
from ptx.geom.tape import (Difference, Intersection, Plane, Sphere,
                           Transformed, Union)
from ptx.shade.materials import Material, transform_material
from ptx.shade import textures as tx
from ptx.utils.device import on_host


def union_array(objects):
    """The reference builds a balanced binary union tree (test.cpp:52-64);
    our Union is n-ary and the compiler merges in one event pass."""
    return Union(*objects)


def make_lens(position, orientation, radius, sphere_radius, material):
    """Biconvex lens = intersection of two spheres (test.cpp:66-72)."""
    position = np.asarray(position, np.float32)
    orientation = np.asarray(orientation, np.float32)
    orientation = orientation / np.linalg.norm(orientation)
    dist = math.sqrt(max(sphere_radius ** 2 - radius ** 2, 0.0))
    return Intersection(
        Sphere(position + orientation * dist, sphere_radius, material),
        Sphere(position - orientation * dist, sphere_radius, material),
    )


def make_lens_pointed_at(position, focus, focus_factor, radius, material):
    """Lensmaker-derived curvature from ior + focus distance
    (test.cpp:74-81)."""
    ior = material.ior
    assert ior > 1 + EPS
    position = np.asarray(position, np.float32)
    focus = np.asarray(focus, np.float32)
    distance = float(np.linalg.norm(focus - position)) * focus_factor
    assert distance > EPS
    return make_lens(position, focus - position, radius,
                     2.0 * distance * (ior - 1.0), material)


# ---------------------------------------------------------------------------
# sky helpers (test.cpp:88-105)
# ---------------------------------------------------------------------------

def make_sky_box(face_images) -> Material:
    """``face_images``: dict with top/bottom/left/right/front/back arrays."""
    return Material(reflect=0.0, scatter=0.0,
                    emissive=tx.Skybox(**face_images))


def make_sky_mirror_sphere(image, scale=(1.0, 1.0, 1.0)) -> Material:
    return Material(reflect=0.0, scatter=0.0,
                    emissive=tx.Multiply(scale, tx.MirrorBall(tx.ImageTex(image))))


def make_sky_spherical(image, scale=(1.0, 1.0, 1.0)) -> Material:
    return Material(reflect=0.0, scatter=0.0,
                    emissive=tx.Multiply(scale, tx.SphericalCoords(tx.ImageTex(image))))


def sky_planes(material, distance=200.0):
    """Six axis-aligned inward-facing planes sharing one emissive material —
    the reference's sky enclosure (test.cpp:134-140)."""
    normals = [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (1, 0, 0), (-1, 0, 0)]
    return [Plane(np.asarray(n, np.float32), distance, material) for n in normals]


def procedural_sky_image(h=64, w=128):
    """A deterministic equirect HDR gradient used when the reference's
    (gitignored) probe asset is unavailable: blue-to-horizon gradient with
    a bright sun disc.  Radiance magnitudes follow real outdoor probes
    (sky ~10², sun ~10⁴) so the demo scene's ×0.01 sky scale
    (test.cpp:123) yields a sensibly exposed image."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    v = ys / (h - 1)          # 0 bottom .. 1 top (lookup flips)
    u = xs / (w - 1)
    sky = 100.0 * np.stack([0.25 + 0.3 * v, 0.4 + 0.4 * v, 0.7 + 0.3 * v],
                           axis=-1)
    sun = np.exp(-(((u - 0.7) * 18) ** 2 + ((v - 0.75) * 18) ** 2))
    img = sky + sun[..., None] * np.array([4000.0, 3600.0, 3000.0],
                                          np.float32)
    return np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=-1)


# ---------------------------------------------------------------------------
# demo + baseline scenes
# ---------------------------------------------------------------------------

@on_host
def make_world(sky_image=None):
    """The reference demo scene (test.cpp:107-145): two small diffuse
    spheres, a glass CSG bulb (sphere ∩ (plane ∪ emissive core)), a glass
    CSG lens, inside a 6-plane equirect-HDR sky rotated 90° about x."""
    mat_diffuse = Material(reflect=0.8, scatter=1.0)
    mat_emit_w = Material(reflect=0.0, scatter=0.0, emissive=2.0)
    mat_glass = Material(reflect=0.7, scatter=0.0, emissive=0.0,
                         transmit=0.9, ior=1.3, transmit_reflect=1.0)

    if sky_image is None:
        sky_image = procedural_sky_image()
    sky = transform_material(
        np.asarray(linalg.rotate_x(2 * math.pi / 4)),
        make_sky_spherical(sky_image, scale=(0.01, 0.01, 0.01)))

    shift = np.asarray(linalg.translate((-1.0, 0.0, 4.0)))
    objects = [
        Sphere((1.0, 0.0, -4.0), 0.2, transform_material(shift, mat_diffuse)),
        Intersection(
            Sphere((1.0, 0.0, -4.0), 1.0, mat_glass),
            Union(
                Plane.from_point((-1.0, 0.0, -0.7), (1.0, 0.0, -4.0), mat_glass),
                Sphere((1.0, 0.0, -4.0), 0.2, transform_material(shift, mat_emit_w)),
            ),
        ),
        Sphere((-1.0, 0.0, -4.0), 0.2, mat_diffuse),
        *sky_planes(sky),
        make_lens((-2.5 / 4, 0.0, -2.5), (-1.0, 0.0, -4.0), 0.5, 1.0, mat_glass),
    ]
    return union_array(objects)


def _stress_sky(sky_image):
    """Sky material for the stress scenes: constant emissive by default,
    or — when ``sky_image`` is given — the demo's own equirect-HDR image
    chain (rotated Multiply→SphericalCoords→ImageTex,
    /root/reference/src/test.cpp:97-105,123): the reference's actual
    big-scene workload class is ``unionArray`` CSG *under an HDR probe*,
    so the large-scene benches must be able to ride the same sky."""
    if sky_image is None:
        return Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    return transform_material(
        np.asarray(linalg.rotate_x(2 * math.pi / 4)),
        make_sky_spherical(sky_image, scale=(0.01, 0.01, 0.01)))


@on_host
def stress_spheres(n: int, seed: int = 0, sky_image=None,
                   transformed: bool = False):
    """Arbitrary-scale stress scene: ``n`` spheres in a jittered grid over
    a ground plane under an emissive sky — the ``unionArray`` big-scene
    mechanism (/root/reference/src/test.cpp:52-64) at benchmarkable leaf
    counts.  Total leaves = n + 7 (ground + 6 sky planes).
    ``sky_image``: optional equirect HDR array — the sky planes then carry
    the demo's image chain (see :func:`_stress_sky`).
    ``transformed``: wrap every sphere in a ``Transformed`` node carrying
    a per-sphere rotation × anisotropic scale (ellipsoids — the
    reference's ``TransformedObject`` vocabulary,
    /root/reference/include/object.h:45-70, at scale)."""
    rng = np.random.default_rng(seed)
    mats = [
        Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
        Material(reflect=(0.3, 0.8, 0.3), scatter=1.0),
        Material(reflect=(0.9, 0.9, 0.9), scatter=0.05),       # mirror-ish
        Material(reflect=(0.9, 0.8, 0.3), scatter=1.0,
                 emissive=(0.4, 0.3, 0.1)),
    ]
    side = max(1, int(math.ceil(math.sqrt(n))))
    spheres = []
    for i in range(n):
        gx, gz = i % side, i // side
        x = (gx - (side - 1) / 2) * 1.2 + rng.uniform(-0.25, 0.25)
        z = -3.0 - gz * 1.2 + rng.uniform(-0.25, 0.25)
        r = rng.uniform(0.15, 0.45)
        s = Sphere((x, -1.0 + r, z), r, mats[i % len(mats)])
        if transformed:
            # rotate about the sphere center, then squash — an ellipsoid
            # pivoting in place (compose order: outermost first)
            c = np.asarray((x, -1.0 + r, z), np.float32)
            t = linalg.compose(
                linalg.translate(c),
                linalg.compose(
                    linalg.rotate_y(rng.uniform(0, 2 * math.pi)),
                    linalg.compose(
                        linalg.scale((rng.uniform(0.7, 1.3), 0.8, 1.2)),
                        linalg.translate(-c))))
            s = Transformed(s, np.asarray(t))
        spheres.append(s)
    ground = Material(reflect=0.6, scatter=1.0)
    sky = _stress_sky(sky_image)
    return union_array([
        *spheres,
        Plane((0.0, 1.0, 0.0), 1.0, ground),
        *sky_planes(sky),
    ])


@on_host
def stress_gadgets(n: int, seed: int = 0, sky_image=None):
    """Mixed-CSG stress scene: ``n`` compound gadgets in a jittered grid
    over a ground plane under an emissive sky.  Gadgets cycle through the
    reference driver's compound vocabulary (test.cpp:126-144): a biconvex
    glass lens (sphere ∩ sphere), a glass bulb with emissive core
    (sphere ∩ (plane ∪ sphere)), and a diffuse sphere with a spherical
    bite taken out (sphere − sphere — exercises difference-B payloads at
    scale).  This is the ``unionArray``-over-solids big-scene shape the
    group-sweep first hit (ptx.geom.fasthit) scales over; leaves ≈ 2.3·n
    + 7."""
    rng = np.random.default_rng(seed)
    glass = Material(reflect=0.7, scatter=0.0, transmit=0.9, ior=1.3,
                     transmit_reflect=1.0)
    diffuse = [
        Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
        Material(reflect=(0.3, 0.8, 0.3), scatter=1.0),
    ]
    emit = Material(reflect=0.0, scatter=0.0, emissive=(2.0, 1.8, 1.2))
    side = max(1, int(math.ceil(math.sqrt(n))))
    gadgets = []
    for i in range(n):
        gx, gz = i % side, i // side
        x = (gx - (side - 1) / 2) * 1.6 + rng.uniform(-0.3, 0.3)
        z = -3.0 - gz * 1.6 + rng.uniform(-0.3, 0.3)
        r = rng.uniform(0.3, 0.55)
        c = (x, -1.0 + r, z)
        kind = i % 3
        if kind == 0:
            gadgets.append(make_lens(c, (0.0, 0.3, 1.0), 0.6 * r,
                                     1.2 * r, glass))
        elif kind == 1:
            gadgets.append(Intersection(
                Sphere(c, r, glass),
                Union(Plane.from_point((-1.0, 0.0, -0.7), c, glass),
                      Sphere(c, 0.3 * r, emit))))
        else:
            bite = (c[0] + 0.6 * r, c[1] + 0.4 * r, c[2] + 0.5 * r)
            gadgets.append(Difference(
                Sphere(c, r, diffuse[i % 2]),
                Sphere(bite, 0.6 * r, diffuse[(i + 1) % 2])))
    ground = Material(reflect=0.6, scatter=1.0)
    sky = _stress_sky(sky_image)
    return union_array([
        *gadgets,
        Plane((0.0, 1.0, 0.0), 1.0, ground),
        *sky_planes(sky),
    ])


@on_host
def baseline_config1():
    """BASELINE config #1: single diffuse sphere + ground plane, constant
    sky — the minimum end-to-end slice."""
    diffuse = Material(reflect=0.8, scatter=1.0)
    ground = Material(reflect=0.6, scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))
    return union_array([
        Sphere((0.0, 0.0, -4.0), 1.0, diffuse),
        Plane((0.0, 1.0, 0.0), 1.0, ground),   # half-space y <= -1
        *sky_planes(sky),
    ])


@on_host
def baseline_config2():
    """BASELINE config #2: CSG union/intersection/difference of transformed
    spheres and planes, diffuse only."""
    red = Material(reflect=(0.8, 0.3, 0.3), scatter=1.0)
    green = Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)
    blue = Material(reflect=(0.3, 0.3, 0.8), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(1.0, 1.0, 1.0))
    csg = Union(
        Difference(
            Sphere((-1.2, 0.0, -4.0), 0.8, red),
            Sphere((-0.8, 0.3, -3.4), 0.5, green),
        ),
        Intersection(
            Sphere((1.0, 0.0, -4.0), 0.8, blue),
            Transformed(
                Sphere((1.4, 0.0, -4.0), 0.8, green),
                np.asarray(linalg.translate((0.0, 0.1, 0.0))),
            ),
        ),
    )
    return union_array([csg, Plane((0.0, 1.0, 0.0), 1.0, red), *sky_planes(sky)])


@on_host
def baseline_config3():
    """BASELINE config #3: specular reflection + glass transmission,
    multi-bounce."""
    mirror = Material(reflect=0.99, scatter=0.0)
    glass = Material(reflect=0.7, scatter=0.0, transmit=0.9, ior=1.3,
                     transmit_reflect=1.0)
    diffuse = Material(reflect=(0.7, 0.6, 0.5), scatter=1.0)
    sky = Material(reflect=0.0, scatter=0.0, emissive=(0.9, 0.9, 1.0))
    return union_array([
        Sphere((-1.0, 0.0, -4.0), 0.8, mirror),
        Sphere((1.0, 0.0, -3.5), 0.7, glass),
        Plane((0.0, 1.0, 0.0), 1.0, diffuse),
        *sky_planes(sky),
    ])


@on_host
def baseline_config4(sky_image=None):
    """BASELINE config #4: HDR environment lighting + image-textured
    material."""
    if sky_image is None:
        sky_image = procedural_sky_image()
    sky = make_sky_spherical(sky_image, scale=(0.05, 0.05, 0.05))
    checker = _checker_image()
    textured = Material(
        reflect=tx.TransformedTex(np.asarray(linalg.scale(0.25)),
                                  tx.ImageTex(checker)),
        scatter=1.0)
    mirror = Material(reflect=0.95, scatter=0.0)
    return union_array([
        Sphere((0.0, 0.0, -4.0), 1.0, textured),
        Sphere((1.8, 0.5, -5.0), 0.8, mirror),
        Plane((0.0, 1.0, 0.0), 1.0, textured),
        *sky_planes(sky),
    ])


def _checker_image(n=8):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy + xx) % 2).astype(np.float32)
    img = np.stack([0.2 + 0.6 * c, 0.25 + 0.5 * c, 0.3 + 0.4 * c,
                    np.ones_like(c)], axis=-1)
    return img
