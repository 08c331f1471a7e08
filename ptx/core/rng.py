"""Random number generation.

Two generators:

1. :func:`sample_unit_ball` et al. — counter-based (threefry, via
   ``jax.random``) samplers keyed per (pixel, sample, bounce).  This is the
   production path: stateless, order-independent, reproducible under any
   sharding.  The reference instead shares ONE mutable LCG across all
   render threads without synchronization (path-trace.h:56,
   src/path-trace.cpp:4), so its multithreaded output is unreproducible by
   construction; a counter-based design is the fix.

2. :class:`ReferenceLCG` — a bit-exact reimplementation of the reference's
   generator (``v = 214013*v + 2531011`` over 64 bits, returning the high
   32 bits, seed XOR 0x12476242; path-trace.h:21-54) for single-threaded
   parity tests of scalar sampling logic.

The reference maps raw draws to floats via
``(x - min) / (max - min) * (hi - lo) + lo`` (vector3d.h:14-34) with
``max = 2**32 - 1``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class ReferenceLCG:
    """Bit-exact clone of the reference ``DefaultRandomEngine``."""

    MIN = 0
    MAX = 0xFFFFFFFF

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, value: int) -> None:
        self.v = np.uint64(value ^ 0x12476242)

    def __call__(self) -> int:
        with np.errstate(over="ignore"):
            self.v = np.uint64(214013) * self.v + np.uint64(2531011)
        return int(self.v >> np.uint64(32))

    def discard(self, count: int) -> None:
        for _ in range(count):
            self()

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        # float32 arithmetic to match uniform_real_distribution<float>
        r = np.float32(self())
        r = np.float32(r / np.float32(self.MAX))
        return float(np.float32(r * np.float32(hi - lo) + np.float32(lo)))


def lcg_stream(seed: int, count: int) -> np.ndarray:
    """Vectorized LCG draw stream (numpy) for oracle tests."""
    out = np.empty(count, dtype=np.uint32)
    v = np.uint64(seed ^ 0x12476242)
    a, c = np.uint64(214013), np.uint64(2531011)
    with np.errstate(over="ignore"):
        for i in range(count):
            v = a * v + c
            out[i] = np.uint32(v >> np.uint64(32))
    return out


# ---------------------------------------------------------------------------
# Counter-based production samplers
# ---------------------------------------------------------------------------

def pixel_keys(base_key, n: int):
    """Split a key into ``n`` per-ray keys (one per flattened ray)."""
    return jax.random.split(base_key, n)


def fold(key, *data):
    for d in data:
        key = jax.random.fold_in(key, d)
    return key


def sample_unit_ball(key, shape=()):
    """Uniform sample inside the radius-1 ball.

    The reference rejection-samples a cube until inside the ball
    (vector3d.h:163-185 with ``max=1, min=0``); uniform-in-ball is the exact
    resulting distribution, so we sample it directly (gaussian direction ×
    cube-root radius) — no rejection, no data-dependent control flow.
    """
    kd, kr = jax.random.split(key)
    d = jax.random.normal(kd, shape + (3,))
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    r = jax.random.uniform(kr, shape) ** (1.0 / 3.0)
    return d * r[..., None]


def sample_square(key, shape=()):
    """Uniform in [0, 1)^2 — pixel-interior AA jitter (path-trace.h:194-195)."""
    return jax.random.uniform(key, shape + (2,))
