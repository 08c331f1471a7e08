"""Vectorized ray-interval ("span") algebra.

The reference represents a ray's intersection with a CSG solid as a stream
of ``Span`` records — ``[t_enter, t_exit]`` intervals carrying boundary
normals and materials — produced by virtual ``SpanIterator`` trees that
merge child streams with two-pointer walks
(``/root/reference/include/span.h``, ``src/union.cpp:84-134``,
``src/intersection.cpp:84-130``, ``src/difference.cpp:84-135``).

That streaming design is hostile to accelerators (virtual dispatch,
data-dependent iteration).  Here a span *list* is a fixed-capacity masked SoA batch — every
ray carries ``K`` slots — and every CSG combinator is one **event merge**:

1. each span contributes an *open* and a *close* event ``(t, payload)``;
2. events from all operands are sorted by ``t`` (a small batched
   ``lax.sort``, ~2K elements, vectorized across the ray wavefront);
3. inclusion depth is a running sum of ±1 deltas; a combinator is just a
   predicate on per-operand depths — union: ``depth > 0``, intersection:
   ``depth == n``, difference: ``depth_a > 0 and depth_b == 0``;
4. predicate *transitions* are the output span boundaries; a second stable
   sort compacts boundary events to the front, where they alternate
   open/close, giving the output list without any scatter.

This reproduces the reference's boundary-payload semantics: the merged
span's boundary takes the normal/material of whichever event caused the
transition, and in a difference the cut surface takes B's payload with the
normal **negated** (span.h:100-112 ``copyEndFromStart``/``copyStartFromEnd``).

Deliberate semantic deltas from the reference (documented, tested):

- Degenerate (zero-length) output spans are dropped.  The reference can
  emit ``[t, t]`` spans at exact tangencies (intersection.cpp:103-114) —
  a measure-zero event under jittered sampling.
- The reference's difference iterator mishandles the case where A starts
  inside B and extends past B's end (difference.cpp:126-130 truncates the
  A span to emptiness instead of clipping to ``[B.end, A.end]``); this
  merge implements the mathematically correct interval difference.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ptx.core.constants import MAX_VALUE

# Sentinel t for masked/invalid slots and events: sorts after every real
# boundary (real |t| <= MAX_VALUE = 1e20).
# numpy scalar, not jnp: importing ptx must not initialize the XLA backend
# (jax.distributed.initialize must run first in multi-process jobs)
_PAD_T = np.float32(3e20)


class SpanList(NamedTuple):
    """Masked SoA span list: batch shape ``(..., K)``.

    Valid spans are sorted by ``t0`` and pairwise disjoint (an invariant
    every constructor in this module maintains).  ``m0``/``m1`` are material
    table indices; the reference stores raw ``const Material*`` pointers in
    its spans (span.h:17,20) — the table index is the array-world pointer.
    """

    t0: jax.Array      # (..., K)   entry distance
    n0: jax.Array      # (..., K, 3) entry normal (unit, outward)
    m0: jax.Array      # (..., K)   entry material id (int32)
    t1: jax.Array      # (..., K)   exit distance
    n1: jax.Array      # (..., K, 3) exit normal (unit, outward)
    m1: jax.Array      # (..., K)   exit material id (int32)
    valid: jax.Array   # (..., K)   bool

    @property
    def capacity(self) -> int:
        return self.t0.shape[-1]

    @property
    def batch_shape(self):
        return self.t0.shape[:-1]


def empty(batch_shape, capacity: int = 1) -> SpanList:
    shape = tuple(batch_shape) + (capacity,)
    return SpanList(
        t0=jnp.full(shape, _PAD_T, jnp.float32),
        n0=jnp.zeros(shape + (3,), jnp.float32),
        m0=jnp.zeros(shape, jnp.int32),
        t1=jnp.full(shape, _PAD_T, jnp.float32),
        n1=jnp.zeros(shape + (3,), jnp.float32),
        m1=jnp.zeros(shape, jnp.int32),
        valid=jnp.zeros(shape, bool),
    )


def single(t0, n0, m0, t1, n1, m1, valid) -> SpanList:
    """Wrap per-ray scalars into a K=1 span list (primitive output)."""
    return SpanList(
        t0=jnp.where(valid, t0, _PAD_T)[..., None],
        n0=n0[..., None, :],
        m0=jnp.broadcast_to(jnp.asarray(m0, jnp.int32), t0.shape)[..., None],
        t1=jnp.where(valid, t1, _PAD_T)[..., None],
        n1=n1[..., None, :],
        m1=jnp.broadcast_to(jnp.asarray(m1, jnp.int32), t0.shape)[..., None],
        valid=valid[..., None],
    )


def _merge(lists_a: Sequence[SpanList], lists_b: Sequence[SpanList], mode: str,
           out_capacity: int | None = None) -> SpanList:
    """Generic n-ary event merge.

    ``mode``:
      - ``"union"``:        inside ⇔ depth_a > 0          (b unused)
      - ``"intersection"``: inside ⇔ depth_a == len(lists_a)  (b unused)
      - ``"difference"``:   inside ⇔ depth_a > 0 and depth_b == 0
    """
    lists = list(lists_a) + list(lists_b)
    assert lists, "merge of zero span lists"
    batch = lists[0].batch_shape
    n_a = len(lists_a)

    ts, opens, da, db, nx, ny, nz, ms = [], [], [], [], [], [], [], []
    for i, sl in enumerate(lists):
        is_b = i >= n_a
        v = sl.valid
        # Difference: B's boundary payload normals are negated when they cut
        # the result (span.h:100-112); every surviving B boundary is a cut.
        nsign = -1.0 if (mode == "difference" and is_b) else 1.0
        for t, n, m, is_open in ((sl.t0, sl.n0, sl.m0, True),
                                 (sl.t1, sl.n1, sl.m1, False)):
            ts.append(jnp.where(v, t, _PAD_T))
            opens.append(jnp.full(t.shape, is_open))
            delta = jnp.where(v, jnp.int32(1 if is_open else -1), jnp.int32(0))
            da.append(jnp.zeros_like(delta) if is_b else delta)
            db.append(delta if is_b else jnp.zeros_like(delta))
            nn = n * nsign
            nx.append(nn[..., 0]); ny.append(nn[..., 1]); nz.append(nn[..., 2])
            ms.append(m)

    cat = lambda xs: jnp.concatenate(xs, axis=-1)
    t = cat(ts)
    is_open = cat(opens)
    delta_a, delta_b = cat(da), cat(db)
    n_x, n_y, n_z = cat(nx), cat(ny), cat(nz)
    mat = cat(ms)

    # Tie-break at equal t: opens before closes.  For union this coalesces
    # touching spans exactly like the reference's merge (union.cpp:105-132
    # uses strict < so equality falls through to the overlap path).  For
    # intersection/difference the opposite order would avoid transient
    # zero-length spans, but those are squashed by the emptiness filter
    # below, so one order serves all modes.
    tie = jnp.where(is_open, jnp.int32(0), jnp.int32(1))

    sorted_ = jax.lax.sort(
        (t, tie, delta_a, delta_b, is_open, n_x, n_y, n_z, mat),
        dimension=-1, num_keys=2, is_stable=True)
    t, _, delta_a, delta_b, is_open, n_x, n_y, n_z, mat = sorted_

    depth_a = jnp.cumsum(delta_a, axis=-1)
    depth_b = jnp.cumsum(delta_b, axis=-1)
    if mode == "union":
        inside = depth_a > 0
    elif mode == "intersection":
        inside = depth_a == len(lists_a)
    elif mode == "difference":
        inside = (depth_a > 0) & (depth_b == 0)
    else:  # pragma: no cover
        raise ValueError(mode)

    inside_prev = jnp.pad(inside[..., :-1], [(0, 0)] * (inside.ndim - 1) + [(1, 0)],
                          constant_values=False)
    boundary = inside != inside_prev
    # Compact boundary events to the front (stable): they alternate
    # open, close, open, close, ... so even slots are starts, odd are ends.
    not_boundary = jnp.where(boundary, jnp.int32(0), jnp.int32(1))
    _, t, n_x, n_y, n_z, mat, bnd = jax.lax.sort(
        (not_boundary, t, n_x, n_y, n_z, mat, boundary),
        dimension=-1, num_keys=1, is_stable=True)

    k_total = sum(sl.capacity for sl in lists)
    k_out = k_total if out_capacity is None else out_capacity

    t0 = t[..., 0::2][..., :k_out]
    t1 = t[..., 1::2][..., :k_out]
    n0 = jnp.stack([n_x[..., 0::2][..., :k_out],
                    n_y[..., 0::2][..., :k_out],
                    n_z[..., 0::2][..., :k_out]], axis=-1)
    n1 = jnp.stack([n_x[..., 1::2][..., :k_out],
                    n_y[..., 1::2][..., :k_out],
                    n_z[..., 1::2][..., :k_out]], axis=-1)
    m0 = mat[..., 0::2][..., :k_out]
    m1 = mat[..., 1::2][..., :k_out]
    pair_valid = bnd[..., 0::2][..., :k_out] & bnd[..., 1::2][..., :k_out]
    valid = pair_valid & (t1 > t0)   # drop degenerate spans

    return SpanList(
        t0=jnp.where(valid, t0, _PAD_T), n0=n0, m0=m0,
        t1=jnp.where(valid, t1, _PAD_T), n1=n1, m1=m1, valid=valid)


def union(*lists: SpanList) -> SpanList:
    """N-ary interval union (union.cpp:84-134, generalized: the scene
    compiler collapses the reference's balanced binary ``unionArray`` tree
    (test.cpp:52-64) into one n-ary merge — one sort instead of log N)."""
    return _merge(lists, (), "union")


def intersection(*lists: SpanList) -> SpanList:
    """N-ary interval intersection (intersection.cpp:84-130); clipped span
    starts take the later operand's payload (``copyStartFromStart``)."""
    return _merge(lists, (), "intersection")


def difference(a: SpanList, b: SpanList) -> SpanList:
    """Interval difference A − B (difference.cpp:84-135): cut surfaces take
    B's material with negated normal."""
    return _merge((a,), (b,), "difference")


def transform_normals(sl: SpanList, nrm_mat) -> SpanList:
    """Map span normals through a (3, 3) linear map and renormalize
    (span.h:122-127; object.h:45-70 applies the wrapped transform's
    inverse-transpose here — see ptx.geom.tape.Transformed)."""
    def xf(n):
        import jax
        out = jnp.einsum("...ij,...kj->...ki", nrm_mat, n,
                         precision=jax.lax.Precision.HIGHEST)
        mag = jnp.linalg.norm(out, axis=-1, keepdims=True)
        return out / jnp.where(mag == 0, 1.0, mag)
    return sl._replace(n0=xf(sl.n0), n1=xf(sl.n1))
