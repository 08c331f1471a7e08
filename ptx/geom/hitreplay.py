"""Differentiable selected-boundary recompute ("hit replay").

Given the *decisions* of a first-hit evaluation — the winning event index
``evt`` (leaf + start/end), ``entering`` and ``hit`` flags — recompute the
differentiable outputs (boundary ``t``, world-space normal) for exactly
that boundary: a per-lane gather of one packed leaf-parameter row plus one
dual-formula (sphere|plane) evaluation.  O(1) leaf work per lane instead
of re-walking all L leaves.

This is the shared backward engine: the blocked and union-sweep first-hit
paths take their differentiable payload from it, and the full-bounce
manual VJP (ptx.integrate.trace) replays the whole bounce with it, so the
scan's reverse pass never re-runs the 2L·L candidate fold.
Selection indices are piecewise-constant in the scene parameters, so
gradients through the replay equal gradients through the live evaluation
(the argmin winner is locally stable) — cross-checked in
tests/test_fasthit.py and tests/test_gradients.py.

Row layout (R = 26):
  sphere: [cx cy cz r  0        W(12) N(9)]
  plane:  [nx ny nz d  inv_mag  W(12) N(9)]
W = world→object affine (identity when untransformed), N = A^{-T}.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ptx.core import linalg
from ptx.core.constants import EPS, MAX_VALUE

ROW = 26


def leaf_rows(leaves, params):
    """Differentiable (L, 26) packed parameter rows for ``leaves`` (the
    (leaf, parity) list from ptx.geom.fasthit.collect_leaves).

    Group-batched: untransformed spheres / planes each pack through ONE
    gather + concat over their whole group (a per-leaf stack of 26-wide
    rows costs real milliseconds at L≈256 — every row is a separate
    tile-padded copy); transformed leaves keep the per-leaf compose
    chain."""
    idx_s, idx_p, idx_o = [], [], []
    for i, (lf, _p) in enumerate(leaves):
        if lf.xform_chain:
            idx_o.append(i)
        elif lf.kind == "sphere":
            idx_s.append(i)
        else:
            idx_p.append(i)

    parts, order = [], []
    eye_tail = jnp.concatenate([jnp.eye(3, 4).reshape(-1),
                                jnp.eye(3).reshape(-1)])
    if idx_s:
        gi = np.array([leaves[i][0].index for i in idx_s])
        c = params["sphere_center"][gi]                       # (Ls, 3)
        r = params["sphere_radius"][gi][:, None]              # (Ls, 1)
        zed = jnp.zeros_like(r)
        tail = jnp.broadcast_to(eye_tail, (len(gi), 21))
        parts.append(jnp.concatenate([c, r, zed, tail], axis=1))
        order += idx_s
    if idx_p:
        gi = np.array([leaves[i][0].index for i in idx_p])
        n = params["plane_normal"][gi]                        # (Lp, 3)
        d = params["plane_d"][gi][:, None]
        inv_mag = 1.0 / jnp.sqrt(jnp.maximum(
            jnp.sum(n * n, axis=1, keepdims=True), 1e-30))
        tail = jnp.broadcast_to(eye_tail, (len(gi), 21))
        parts.append(jnp.concatenate([n, d, inv_mag, tail], axis=1))
        order += idx_p
    # transformed leaves: batched by (kind, chain length) — one batched
    # compose+inverse per group instead of an O(L) per-leaf
    # compose/inverse/concat op-graph (linalg ops broadcast over leading
    # axes)
    xf_groups: dict = {}
    for i in idx_o:
        lf, _p = leaves[i]
        xf_groups.setdefault((lf.kind, len(lf.xform_chain)),
                             []).append(i)
    for (kind, clen), idxs in xf_groups.items():
        gi = np.array([leaves[i][0].index for i in idxs])
        ch = np.array([leaves[i][0].xform_chain for i in idxs])  # (N, k)
        w = params["xform"][ch[:, 0]]
        for j in range(1, clen):
            w = linalg.compose(w, params["xform"][ch[:, j]])
        w_inv = linalg.inverse(w)                          # (N, 3, 4)
        if kind == "sphere":
            c = params["sphere_center"][gi]
            r = params["sphere_radius"][gi][:, None]
            head = jnp.concatenate([c, r, jnp.zeros_like(r)], axis=1)
        else:
            n = params["plane_normal"][gi]
            d = params["plane_d"][gi][:, None]
            inv_mag = 1.0 / jnp.sqrt(jnp.maximum(
                jnp.sum(n * n, axis=1, keepdims=True), 1e-30))
            head = jnp.concatenate([n, d, inv_mag], axis=1)
        tail = jnp.concatenate(
            [w_inv.reshape(-1, 12),
             jnp.transpose(w_inv[:, :, :3], (0, 2, 1)).reshape(-1, 9)],
            axis=1)
        parts.append(jnp.concatenate([head, tail], axis=1))
        order += idxs

    rows = jnp.concatenate(parts, axis=0)
    inv = np.empty(len(leaves), np.int32)
    inv[np.array(order)] = np.arange(len(leaves))
    return rows[inv]                             # (L, 26)


def build_hit_replay(leaves, parity_np=None):
    """Returns ``replay(params, origin, direction, evt, entering, hit)``
    → ``(t, normal)`` matching the live hit_fn's masked outputs.

    ``evt`` is the flat event index in [0, 2L): < L ⇒ start boundary of
    leaf evt, ≥ L ⇒ end boundary of leaf evt−L.  Lanes with ``hit`` False
    return t=0 / normal=0 (the live contract)."""
    L = len(leaves)
    is_sphere_np = np.array([lf.kind == "sphere" for lf, _ in leaves])
    if parity_np is None:
        parity_np = np.array([p for _, p in leaves], np.float32)
    # constant per-leaf aux columns appended to the packed rows so the
    # whole replay rides ONE per-lane gather instead of three (the 1-wide
    # is_sphere and parity columns would each be a per-lane gather of
    # their own)
    aux_np = np.stack([is_sphere_np.astype(np.float32),
                       parity_np.astype(np.float32)], axis=1)    # (L, 2)

    def recompute_flat(params, ox, oy, oz, dx, dy, dz, best_i):
        from ptx.ops.tableops import table_lookup_aug
        leaf_idx = jnp.where(best_i >= L, best_i - L, best_i)
        is_start = best_i < L
        # ONE (B, 28) fetch with a one-hot-matmul transpose
        row = table_lookup_aug(leaf_rows(leaves, params),
                               jnp.asarray(aux_np), leaf_idx)
        sph = row[:, 26] > 0.5

        w = row[:, 5:17]
        nrm = row[:, 17:26]
        lox = w[:, 0] * ox + w[:, 1] * oy + w[:, 2] * oz + w[:, 3]
        loy = w[:, 4] * ox + w[:, 5] * oy + w[:, 6] * oz + w[:, 7]
        loz = w[:, 8] * ox + w[:, 9] * oy + w[:, 10] * oz + w[:, 11]
        ldx = w[:, 0] * dx + w[:, 1] * dy + w[:, 2] * dz
        ldy = w[:, 4] * dx + w[:, 5] * dy + w[:, 6] * dz
        ldz = w[:, 8] * dx + w[:, 9] * dy + w[:, 10] * dz

        # sphere formula
        ocx, ocy, ocz = lox - row[:, 0], loy - row[:, 1], loz - row[:, 2]
        r = row[:, 3]
        a = ldx * ldx + ldy * ldy + ldz * ldz
        b = ocx * ldx + ocy * ldy + ocz * ldz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc_raw = b * b - a * cc
        # guard: lanes whose selected leaf is a plane evaluate this branch
        # on nonsense params; sqrt'(0)=inf would NaN the where-cotangent
        disc = jnp.where(disc_raw > 1e-12, disc_raw, 1.0)
        sq = jnp.sqrt(disc)
        sa = jnp.where(a == 0.0, 1.0, a)
        t_s = jnp.where(is_start, (-b - sq) / sa, (-b + sq) / sa)
        inv_r = 1.0 / jnp.where(r == 0.0, 1.0, r)
        snx = (ocx + t_s * ldx) * inv_r
        sny = (ocy + t_s * ldy) * inv_r
        snz = (ocz + t_s * ldz) * inv_r

        # plane formula
        pn0, pn1, pn2, pd, pim = (row[:, 0], row[:, 1], row[:, 2],
                                  row[:, 3], row[:, 4])
        divisor = ldx * pn0 + ldy * pn1 + ldz * pn2
        numer = -pd - (lox * pn0 + loy * pn1 + loz * pn2)
        safe_div = jnp.where(jnp.abs(divisor) < EPS * EPS, 1.0, divisor)
        t_p = numer / safe_div      # finite plane-crossing boundaries only
        pnx, pny, pnz = pn0 * pim, pn1 * pim, pn2 * pim

        t_sel = jnp.where(sph, t_s, t_p)
        nx0 = jnp.where(sph, snx, pnx)
        ny0 = jnp.where(sph, sny, pny)
        nz0 = jnp.where(sph, snz, pnz)
        # ±MAX sentinel boundaries carry no useful gradient; pin them
        sentinel = jnp.abs(t_sel) >= MAX_VALUE
        t_sel = jnp.where(sentinel, jax.lax.stop_gradient(t_sel), t_sel)

        # push normal through A^{-T} and renormalize
        wx = nrm[:, 0] * nx0 + nrm[:, 1] * ny0 + nrm[:, 2] * nz0
        wy = nrm[:, 3] * nx0 + nrm[:, 4] * ny0 + nrm[:, 5] * nz0
        wz = nrm[:, 6] * nx0 + nrm[:, 7] * ny0 + nrm[:, 8] * nz0
        mag = jnp.sqrt(wx * wx + wy * wy + wz * wz)
        inv = 1.0 / jnp.where(mag == 0.0, 1.0, mag)
        # parity rides the same packed row (column 27) — no second gather
        return t_sel, wx * inv, wy * inv, wz * inv, row[:, 27]

    def replay(params, origin, direction, evt, entering, hit):
        shape = origin.shape[:-1]
        ox, oy, oz = (origin[..., i].reshape(-1) for i in range(3))
        dx, dy, dz = (direction[..., i].reshape(-1) for i in range(3))
        evt_f = evt.reshape(-1)
        t, nx, ny, nz, par = recompute_flat(params, ox, oy, oz, dx, dy, dz,
                                            evt_f)
        sign = par * jnp.where(entering.reshape(-1), 1.0, -1.0)
        hmask = hit.reshape(-1)
        t = jnp.where(hmask, t, 0.0).reshape(shape)
        # miss lanes get a CONSTANT unit placeholder, not the zero vector:
        # downstream normalize/refract have infinite-slope points at n=0
        # and a zero cotangent times an infinite partial is NaN — the
        # placeholder keeps every masked lane's backward finite while
        # contributing exactly zero gradient (it is parameter-independent)
        normal = jnp.stack(
            [jnp.where(hmask, nx * sign, 0.0),
             jnp.where(hmask, ny * sign, 0.0),
             jnp.where(hmask, nz * sign, 1.0)],
            axis=-1).reshape(shape + (3,))
        return t, normal

    return replay
