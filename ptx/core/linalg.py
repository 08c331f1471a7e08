"""Batched 3-vector and affine-transform math.

The reference carries a hand-written ``Vector3D`` value class and a 3x4
affine ``Matrix`` (``/root/reference/include/vector3d.h:36-219``,
``/root/reference/include/transform.h``).  Here vectors are just ``(..., 3)``
jnp arrays and affines are ``(..., 3, 4)`` arrays; every op is batched and
differentiable.

Affine convention
-----------------
``A`` has shape ``(3, 4)``: the left ``(3, 3)`` block is the linear part
``L``, the last column is the translation ``t``; the implied last row is
``[0 0 0 1]``.  ``apply(A, v) = L @ v + t``.

``compose(a, b)`` returns the affine whose action is *b first, then a is
NOT what the reference means*: the reference's ``m.concat(rt)`` satisfies
``m.concat(rt).apply(v) == m.apply(rt.apply(v))`` (verified from
``TransformedTexture::transform``, texture.h:86-89 together with the free
``transform(m, texture)`` wrapper at texture.h:92-98), i.e. the *argument*
is applied first.  We expose that as ``compose(outer, inner)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# einsum/matmul precision: HIGHEST everywhere in this module.  These
# contractions build TRANSFORMS (rays into object space, normals back,
# affine composition/inversion) — at default precision a matmul unit
# runs bf16 passes or TF32 (GPU tensor cores), which would carry
# ~0.1-0.4% error into geometry (see ptx/geom/fasthit.py
# _leaf_intervals_grouped for the plane-interval case).
_HP = jax.lax.Precision.HIGHEST

from ptx.core.constants import EPS


# ---------------------------------------------------------------------------
# vec3 ops (all broadcast over leading batch dims)
# ---------------------------------------------------------------------------

def vec3(x, y, z, dtype=jnp.float32):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def abs_squared(v):
    return dot(v, v)


def norm(v):
    # guarded sqrt: at v=0 the norm is returned as exact 0 with a zero
    # (sub)gradient instead of sqrt'(0)=inf NaN-ing masked backward lanes
    mag2 = abs_squared(v)
    safe = jnp.sqrt(jnp.where(mag2 == 0.0, 1.0, mag2))
    return jnp.where(mag2 == 0.0, 0.0, safe)


def normalize(v):
    """Normalize; zero vectors pass through unchanged (reference
    ``vector3d.h:115-120`` substitutes magnitude 1 for 0).

    Guarded BEFORE the sqrt: ``sqrt`` has infinite slope at 0, and a zero
    cotangent times an infinite partial is NaN — masked lanes must stay
    finite in reverse mode."""
    mag2 = abs_squared(v)
    safe = jnp.sqrt(jnp.where(mag2 == 0.0, 1.0, mag2))
    return v / safe[..., None]


def reflect(d, n):
    """Mirror ``d`` about (normalized) ``n`` (vector3d.h:186-190)."""
    n = normalize(n)
    return d - 2.0 * dot(d, n)[..., None] * n


def refract_strength(d, relative_ior, n):
    """The reference's Fresnel-ish transmission weight: the **fourth root**
    of ``1 - eta^2 (1 - cos^2)`` — not physical Fresnel, but it defines
    reference output (vector3d.h:191-202).  Returns 0 outside validity
    (bad ior, zero vectors, total internal reflection)."""
    d = jnp.asarray(d)
    eta = jnp.asarray(relative_ior)
    n_unit = normalize(n)
    i = normalize(d)
    idn = dot(i, n_unit)
    arg = 1.0 - eta[...] ** 2 * (1.0 - idn * idn)
    ok = (
        (eta > EPS)
        & (eta < 1.0 / EPS)
        & (abs_squared(n) > 0.0)
        & (abs_squared(d) > 0.0)
        & (arg > 0.0)
    )
    return jnp.where(ok, jnp.sqrt(jnp.sqrt(jnp.where(ok, arg, 1.0))), 0.0)


def refract(d, relative_ior, n):
    """Refraction direction (vector3d.h:203-214).  The reference's sign
    convention: with ``idn = i·n``, ``t = eta*i - (eta*idn + sqrt(arg))*n``.
    Returns the zero vector on total internal reflection / invalid input —
    the caller treats that as "no transmission" (path-trace.h:113-121)."""
    eta = jnp.asarray(relative_ior)
    n_unit = normalize(n)
    i = normalize(d)
    idn = dot(i, n_unit)
    arg = 1.0 - eta[...] ** 2 * (1.0 - idn * idn)
    ok = (
        (eta > EPS)
        & (eta < 1.0 / EPS)
        & (abs_squared(n) > 0.0)
        & (abs_squared(d) > 0.0)
        & (arg >= 0.0)
    )
    # guard value 1.0, not 0.0: sqrt'(0)=inf would NaN the masked lanes'
    # backward (forward is unaffected — ~ok lanes return the zero vector).
    # ok admits arg == 0 exactly (the reference treats grazing TIR as a
    # valid refraction, vector3d.h:203-214) — but sqrt'(0) = inf, and the
    # combination IS reachable: eta = 1 (the default ior) with d ⊥ n gives
    # arg ≡ 0, which compaction filler lanes construct exactly (found by
    # the sharded compacted-manual-VJP dryrun: 0·inf → NaN d(ior) even
    # with zero cotangents).  The 1e-20 floor keeps the value error below
    # f32 resolution (sqrt → 1e-10) and the partial finite (≤ 5e9).
    safe_arg = jnp.where(ok, jnp.maximum(arg, 1e-20), 1.0)
    t = eta[..., None] * i - (eta * idn + jnp.sqrt(safe_arg))[..., None] * n_unit
    return jnp.where(ok[..., None], normalize(t), jnp.zeros_like(t))


# ---------------------------------------------------------------------------
# affine (3, 4) transforms
# ---------------------------------------------------------------------------

def identity_affine(dtype=jnp.float32):
    return jnp.concatenate(
        [jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype=dtype)], axis=-1)


def affine(linear, translation):
    linear = jnp.asarray(linear, jnp.float32).reshape((3, 3))
    translation = jnp.asarray(translation, jnp.float32).reshape((3, 1))
    return jnp.concatenate([linear, translation], axis=-1)


def translate(t):
    return affine(jnp.eye(3), jnp.asarray(t, jnp.float32))


def scale(s):
    s = jnp.broadcast_to(jnp.asarray(s, jnp.float32), (3,))
    return affine(jnp.diag(s), jnp.zeros(3))


def rotate(axis, angle):
    """Axis-angle rotation via the versine form (transform.h:207-225)."""
    a = normalize(jnp.asarray(axis, jnp.float32))
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    v = 1.0 - c
    x, y, z = a[0], a[1], a[2]
    linear = jnp.stack([
        jnp.stack([x * x + (1 - x * x) * c, x * y * v - z * s, x * z * v + y * s]),
        jnp.stack([x * y * v + z * s, y * y + (1 - y * y) * c, y * z * v - x * s]),
        jnp.stack([x * z * v - y * s, y * z * v + x * s, z * z + (1 - z * z) * c]),
    ])
    return affine(linear, jnp.zeros(3))


def rotate_x(angle):
    return rotate(jnp.array([1.0, 0.0, 0.0]), angle)


def rotate_y(angle):
    return rotate(jnp.array([0.0, 1.0, 0.0]), angle)


def rotate_z(angle):
    return rotate(jnp.array([0.0, 0.0, 1.0]), angle)


def apply(A, v):
    """``L @ v + t`` with batched ``A`` ``(..., 3, 4)`` / ``v`` ``(..., 3)``."""
    A = jnp.asarray(A)
    return jnp.einsum("...ij,...j->...i", A[..., :, :3], v,
                      precision=_HP) + A[..., :, 3]


def apply_linear(A, v):
    """Linear part only — the reference's ``applyNoTranslate``
    (transform.h:416-421), used for directions and normals."""
    return jnp.einsum("...ij,...j->...i", jnp.asarray(A)[..., :, :3],
                      v, precision=_HP)


def compose(outer, inner):
    """Affine whose action is ``apply(outer, apply(inner, v))``."""
    outer = jnp.asarray(outer)
    inner = jnp.asarray(inner)
    lin = jnp.matmul(outer[..., :, :3], inner[..., :, :3], precision=_HP)
    t = jnp.einsum("...ij,...j->...i", outer[..., :, :3],
                   inner[..., :, 3], precision=_HP) + outer[..., :, 3]
    return jnp.concatenate([lin, t[..., :, None]], axis=-1)


def determinant(A):
    return jnp.linalg.det(jnp.asarray(A)[..., :, :3])


def inverse(A):
    """Closed-form inverse of the affine (transform.h:350-383)."""
    A = jnp.asarray(A)
    lin_inv = jnp.linalg.inv(A[..., :, :3])
    t = -jnp.einsum("...ij,...j->...i", lin_inv, A[..., :, 3],
                    precision=_HP)
    return jnp.concatenate([lin_inv, t[..., :, None]], axis=-1)


def transform_ray(A, origin, direction):
    """Transform a ray: origin affinely, direction linearly
    (transform.h:429-432).  ``t`` parameterization is preserved."""
    return apply(A, origin), apply_linear(A, direction)
