"""Scalar NumPy oracle re-deriving the reference renderer's equations.

Implements the recursion of ``/root/reference/include/path-trace.h:59-206``
(branching transmission + scatter, strength-driven termination), the
primitive span math of sphere.cpp/plane.cpp, and 1-D CSG with the
reference's payload rules — in straight-line Python, sharing no code with
``ptx``.  Used to validate the vectorized wavefront integrator:
deterministic paths exactly, stochastic paths in expectation.

``scatter_cap`` bounds how many children are actually SPAWNED from the
reference's adaptive fan-out (``scatter_ray_count =
int(10000·strength·addFactor·sc)``, path-trace.h:130) to keep oracle
runtime sane; spawning fewer iid children preserves the estimator's
expectation.  The per-child *strength* divisor stays the UNCAPPED count
(path-trace.h:162 ``strength / scatter_ray_count``): that division is the
reference's termination rule — after one full-strength diffuse bounce each
child drops below ``eps`` and stops at its next hit — and capping it would
silently let oracle paths live longer than the reference's.
"""

from __future__ import annotations

import math

import numpy as np

EPS = 1e-3
MAX_VALUE = 1e20


# ---------------------------------------------------------------------------
# vec helpers (float64 internally; fine for tolerance-based comparison)
# ---------------------------------------------------------------------------

def normalize(v):
    m = np.linalg.norm(v)
    return v / (m if m != 0 else 1.0)


def reflect(d, n):
    n = normalize(n)
    return d - 2.0 * np.dot(d, n) * n


def refract_strength(d, eta, n):
    if eta < EPS or eta > 1 / EPS or not np.any(n) or not np.any(d):
        return 0.0
    n = normalize(n); i = normalize(d)
    idn = float(np.dot(i, n))
    arg = 1.0 - eta * eta * (1.0 - idn * idn)
    if arg <= 0:
        return 0.0
    return math.sqrt(math.sqrt(arg))


def refract(d, eta, n):
    if eta < EPS or eta > 1 / EPS or not np.any(n) or not np.any(d):
        return np.zeros(3)
    n = normalize(n); i = normalize(d)
    idn = float(np.dot(i, n))
    arg = 1.0 - eta * eta * (1.0 - idn * idn)
    if arg < 0:
        return np.zeros(3)
    return normalize(eta * i - (eta * idn + math.sqrt(arg)) * n)


# ---------------------------------------------------------------------------
# scene model
# ---------------------------------------------------------------------------

class OMaterial:
    def __init__(self, reflect=(1, 1, 1), scatter=1.0, emissive=(0, 0, 0),
                 transmit=(0, 0, 0), ior=1.0, transmit_reflect=0.0):
        as3 = lambda v: np.broadcast_to(np.asarray(v, float), (3,)).astype(float)
        self.reflect = as3(reflect)
        self.scatter = float(scatter)
        # positional emissive (image-textured skies in the matched-seed
        # harness, tools/matched_seed.py) rides as a callable pos -> (3,)
        self.emissive = emissive if callable(emissive) else as3(emissive)
        self.transmit = as3(transmit)
        self.ior = float(ior)
        self.transmit_reflect = float(transmit_reflect)


class Boundary:
    __slots__ = ("t", "normal", "mat")

    def __init__(self, t, normal, mat):
        self.t = float(t)
        self.normal = np.asarray(normal, float)
        self.mat = mat

    def negated(self):
        return Boundary(self.t, -self.normal, self.mat)


class OSphere:
    def __init__(self, center, radius, mat):
        self.center = np.asarray(center, float)
        self.radius = float(radius)
        self.mat = mat

    def spans(self, o, d):
        oc = o - self.center
        a = float(np.dot(d, d))
        b = float(np.dot(oc, d))
        c = float(np.dot(oc, oc)) - self.radius ** 2
        disc = b * b - a * c
        if disc <= EPS:
            return []
        s = math.sqrt(disc)
        t0 = (-b - s) / a
        t1 = (-b + s) / a
        n0 = normalize(o + t0 * d - self.center)
        n1 = normalize(o + t1 * d - self.center)
        return [(Boundary(t0, n0, self.mat), Boundary(t1, n1, self.mat))]


class OPlane:
    def __init__(self, normal, dist, mat):
        self.normal = np.asarray(normal, float)
        self.d = float(dist)
        self.mat = mat

    def spans(self, o, d):
        n = self.normal
        divisor = float(np.dot(d, n))
        numerator = -self.d - float(np.dot(o, n))
        nb = normalize(n)
        if abs(divisor) < EPS * EPS or abs(numerator / divisor) >= MAX_VALUE:
            if abs(numerator) < EPS * EPS:
                return [(Boundary(-MAX_VALUE, nb, self.mat),
                         Boundary(MAX_VALUE, nb, self.mat))]
            return []
        t = numerator / divisor
        if divisor < 0:
            return [(Boundary(t, nb, self.mat), Boundary(MAX_VALUE, nb, self.mat))]
        return [(Boundary(-MAX_VALUE, nb, self.mat), Boundary(t, nb, self.mat))]


def _inside(spans, t):
    return any(b0.t < t < b1.t for b0, b1 in spans)


class OUnion:
    def __init__(self, *objs):
        self.objs = objs

    def spans(self, o, d):
        all_spans = [s for ob in self.objs for s in ob.spans(o, d)]
        events = []
        for b0, b1 in all_spans:
            events.append((b0.t, 0, b0, b1))
        # sweep: merge overlapping/touching
        all_spans.sort(key=lambda s: s[0].t)
        out = []
        for b0, b1 in all_spans:
            if out and b0.t <= out[-1][1].t:
                if b1.t > out[-1][1].t:
                    out[-1] = (out[-1][0], b1)
            else:
                out.append((b0, b1))
        return out


class OIntersection:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def spans(self, o, d):
        out = []
        for a0, a1 in self.a.spans(o, d):
            for b0, b1 in self.b.spans(o, d):
                lo = a0 if a0.t >= b0.t else b0
                hi = a1 if a1.t <= b1.t else b1
                if hi.t > lo.t:
                    out.append((lo, hi))
        out.sort(key=lambda s: s[0].t)
        return out


class ODifference:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def spans(self, o, d):
        bs = self.b.spans(o, d)
        out = []
        for a0, a1 in self.a.spans(o, d):
            pieces = [(a0, a1)]
            for b0, b1 in bs:
                nxt = []
                for p0, p1 in pieces:
                    if b1.t <= p0.t or b0.t >= p1.t:
                        nxt.append((p0, p1))
                        continue
                    if b0.t > p0.t:
                        nxt.append((p0, b0.negated()))   # cut: B start, negated
                    if b1.t < p1.t:
                        nxt.append((b1.negated(), p1))   # cut: B end, negated
                pieces = nxt
            out.extend(pieces)
        out = [(p0, p1) for p0, p1 in out if p1.t > p0.t]
        out.sort(key=lambda s: s[0].t)
        return out


# ---------------------------------------------------------------------------
# the recursion (path-trace.h:59-165)
# ---------------------------------------------------------------------------

def trace_ray(world, o, d, depth, rng, strength=1.0, scatter_cap=10000):
    spans = world.spans(o, d)
    hit = None
    for b0, b1 in spans:
        if b0.t >= MAX_VALUE:
            return np.zeros(3)
        if b0.t >= EPS:
            hit = (b0.t, b0.normal, b0.mat, 1.0 / b0.mat.ior)
            break
        if b1.t >= MAX_VALUE:
            return np.zeros(3)
        if b1.t >= EPS:
            hit = (b1.t, -b1.normal, b1.mat, b1.mat.ior)
            break
    if hit is None:
        return np.zeros(3)
    t, normal, mat, ior = hit
    pos = o + t * d
    retval = (np.asarray(mat.emissive(pos), float).copy()
              if callable(mat.emissive) else mat.emissive.copy())
    add_factor = 1.0
    if depth <= 0 or strength < EPS:
        return retval

    refract_factor = (min(1.0, max(0.0, mat.transmit_reflect))
                      * refract_strength(d, ior, normal))
    if refract_factor > EPS:
        rd = refract(d, ior, normal)
        if np.any(rd):
            transmit = mat.transmit
            t_strength = float(
                np.float32(strength) * np.float32(refract_factor)
                * np.float32(add_factor)
                * np.float32(np.sqrt(np.float32(
                    np.float32(transmit[0]) ** 2
                    + np.float32(transmit[1]) ** 2
                    + np.float32(transmit[2]) ** 2))))
            retval = retval + add_factor * refract_factor * transmit * trace_ray(
                world, pos, rd, depth - 1, rng,
                t_strength,
                scatter_cap)
            add_factor *= 1.0 - refract_factor
    if add_factor < EPS:
        return retval

    sc = min(1.0, max(0.0, mat.scatter))
    # the DRAW-AFFECTING quantities run in float32 to track the
    # reference binary's arithmetic exactly (matched-seed mode,
    # tools/matched_seed.py): the child count int(10000·s·a·sc), the
    # rejection-accept dot test, and the strength recursion all gate how
    # many LCG draws are consumed — one f64-vs-f32 rounding flip
    # desynchronizes the whole remaining stream (path-trace.h:118-162)
    count = int(np.float32(10000.0) * np.float32(strength)
                * np.float32(add_factor) * np.float32(sc))
    if sc <= EPS or count == 0:
        count = 1
    spawn = min(count, scatter_cap)
    reflect_tint = mat.reflect
    reflected = reflect(d, normal)
    for _ in range(spawn):
        rdir = reflected
        if sc > EPS:
            for _ in range(1000):
                ball = _rand_ball(rng)
                rdir = (ball.astype(np.float32)
                        + np.float32(np.float32(1.0) / np.float32(sc)
                                     - np.float32(1.0))
                        * reflected.astype(np.float32))
                nr = np.float32(normal[0]) * rdir[0] \
                    + np.float32(normal[1]) * rdir[1] \
                    + np.float32(normal[2]) * rdir[2]
                if nr > np.float32(EPS):
                    break
            else:
                return retval
            rdir = normalize(rdir)
        factor = 1.0 - (1.0 - float(np.dot(rdir, normal))) * sc
        child_strength = float(
            np.float32(strength) / np.float32(count)
            * np.float32(add_factor) * np.float32(factor)
            * np.float32(np.sqrt(np.float32(
                np.float32(reflect_tint[0]) ** 2
                + np.float32(reflect_tint[1]) ** 2
                + np.float32(reflect_tint[2]) ** 2))))
        retval = retval + add_factor / spawn * factor * reflect_tint * trace_ray(
            world, pos, rdir, depth - 1, rng,
            child_strength,
            scatter_cap)
    return retval


def _rand_ball(rng):
    # accept test in float32 — the reference's |v| > 1 reject is f32
    # (vector3d.h:163-185), and a boundary flip desyncs the matched-seed
    # LCG stream
    while True:
        v = rng.uniform(-1.0, 1.0, 3)
        v32 = np.asarray(v, np.float32)
        mag = np.float32(np.sqrt(np.float32(
            v32[0] * v32[0] + v32[1] * v32[1] + v32[2] * v32[2])))
        if not (mag > np.float32(1.0)):
            return v


def trace_pixel(world, px, py, w, h, spp, depth, screen_w, screen_h,
                screen_d, rng, jitter=True, scatter_cap=10000):
    acc = np.zeros(3)
    for _ in range(spp):
        jx = rng.uniform() if jitter else 0.0
        jy = rng.uniform() if jitter else 0.0
        x = 2.0 * (px + jx) / w - 1.0
        y = 1.0 - 2.0 * (py + jy) / h
        d = np.array([x * screen_w, y * screen_h, -screen_d])
        acc += trace_ray(world, np.zeros(3), d, depth, rng,
                         scatter_cap=scatter_cap)
    return acc / spp


# ---------------------------------------------------------------------------
# textures (texture.h, image_texture.h, transform_texture.h, filter_texture.h)
# ---------------------------------------------------------------------------

def texture(tex, pos):
    """Evaluate a ptx texture expression tree at points ``pos`` (N, 3)
    in float64 NumPy, straight from the reference's lookup rules.
    Supports Constant, ImageTex, TransformedTex, SphericalCoords,
    MirrorBall and Multiply — the sky chains the scenes use."""
    from ptx.shade import textures as tx

    pos = np.asarray(pos, np.float64)
    n = pos.shape[0]
    if isinstance(tex, tx.Constant):
        return np.broadcast_to(np.asarray(tex.color, np.float64), (n, 3))
    if isinstance(tex, tx.Multiply):
        return texture(tex.child, pos) * np.asarray(tex.factor, np.float64)
    if isinstance(tex, tx.TransformedTex):
        A = np.asarray(tex.transform, np.float64).reshape(3, 4)
        return texture(tex.child, pos @ A[:, :3].T + A[:, 3])
    if isinstance(tex, tx.SphericalCoords):
        u, w = np.zeros(n), np.zeros(n)
        nz = np.any(pos != 0.0, axis=1)
        v = pos[nz] / np.linalg.norm(pos[nz], axis=1, keepdims=True)
        u[nz] = np.arctan2(v[:, 1], v[:, 0]) * 0.5 / math.pi + 0.5
        w[nz] = np.arcsin(np.clip(v[:, 2], -1, 1)) / (math.pi / 2) * 0.5 + 0.5
        return texture(tex.child, np.stack([u, w, np.zeros(n)], 1))
    if isinstance(tex, tx.MirrorBall):
        u, w = np.zeros(n), np.zeros(n)
        for i in range(n):
            p = pos[i]
            if not np.any(p != 0.0):
                continue
            v = p / np.linalg.norm(p)
            d = math.sqrt(max(2.0 + 2.0 * v[2], 0.0))
            if v[2] <= -1.0 or d == 0.0:
                u[i], w[i] = 0.0, 0.5
            else:
                u[i], w[i] = v[0] / d * 0.5 + 0.5, v[1] / d * 0.5 + 0.5
        return texture(tex.child, np.stack([u, w, np.zeros(n)], 1))
    if isinstance(tex, tx.ImageTex):
        img = np.asarray(tex.image, np.float64)
        h, wd = img.shape[:2]
        x = pos[:, 0] - np.floor(pos[:, 0])
        y = 1.0 - (pos[:, 1] - np.floor(pos[:, 1]))
        xi = np.floor(x * wd).astype(np.int64)
        yi = np.floor(y * h).astype(np.int64)
        inb = (xi >= 0) & (xi < wd) & (yi >= 0) & (yi < h)
        out = np.zeros((n, 3))
        ch = img[yi[inb], xi[inb]]
        out[inb] = (np.repeat(ch[:, 3:4], 3, 1) if tex.alpha else ch[:, :3])
        return out
    raise TypeError(f"oracle has no rule for {type(tex)!r}")
