"""Direct first-hit evaluation — the hot-path replacement for cascaded
span merges.

Observation: the integrator (path-trace.h:59-99) consumes only the FIRST
qualifying boundary of the root CSG solid's span list.  Materializing the
merged span list per CSG node (ptx.geom.spans: one 2K-event sort per node)
does far more work than that answer needs.  Equivalent one-pass scheme:

1. every primitive leaf contributes its 2 boundary times — 2L candidates
   for L leaves (no ordering ever imposed on them);
2. root *insideness* just before / just after each candidate comes from
   evaluating the boolean CSG tape over per-leaf membership bits
   (``t0 < t <= t1`` / ``t0 <= t < t1``) — two (2L × L) compare tensors
   and two boolean folds, pure vectorized algebra, no merging;
3. a candidate where before ≠ after is a boundary of the root solid;
   the first-hit walk collapses to "**minimum** boundary with
   ``t >= EPS``" — provably identical to the reference's per-span
   condition ladder, because a span's qualifying boundary is always the
   earliest root boundary ≥ EPS:
   - that boundary's ``t >= MAX_VALUE``  ⇒ escaped (sky sentinel rule),
   - inside-after  ⇒ entry hit (leaf normal, 1/ior),
   - outside-after ⇒ exit hit (negated normal, ior);
4. boundary payload = the generating leaf's normal/material; a leaf under
   the B-side of an odd number of ``Difference`` nodes negates its normal
   (the ``copyEndFromStart``/``copyStartFromEnd`` rule, span.h:100-112),
   so ``final = n_event · parity · (+1 entry / −1 exit)``.

Exactly-coincident boundaries (touching union spans) merge automatically:
both membership bits flip inside one evaluation, so no root transition is
seen — the union-coalescing rule without any sort tie-break.  Degenerate
tangencies (measure-zero under jittered sampling) report as misses where
the reference emits zero-length spans.

Cost per ray: two (2L × L) bool compare/fold tensors + one argmin —
no sort at all — versus ~nodes × sort(2K·9 channels) for the merge
cascade.  No span-capacity ceiling, same gradients (boundary ``t``/
normals differentiable, selection index stop-gradient).  Cross-checked
against the span-merge path in tests/test_fasthit.py.

Three evaluation strategies share the same semantics:

- **dense** (small L): materialize the full (2L, L, B) compare tensors and
  per-leaf normal stacks in one shot — maximum fusion for demo-scale
  scenes;
- **candidate-blocked** (large L, any tape): scan candidates in fixed-size
  blocks (peak memory O(block·L·B)) carrying a running argmin, then
  recompute the winner's normal with the O(1) selected-leaf replay
  (ptx.geom.hitreplay).  Memory O(L·B), no unrolled-code growth;
- **union sweep** (large L, union-decomposable tapes — the ``unionArray``
  big-scene shape, /root/reference/src/test.cpp:52-64): for a union of
  groups the membership fold degenerates to interval coverage.  The
  ``fixpoint`` mode finds the first boundary *sort-free*: ``min start``
  for rays outside the coverage at EPS, else the merged-chain exit via a
  fixed-point ``E ← max{e : s ≤ E}`` (2-4 masked-max passes on real
  scenes) — O(L·hops) work vs the O(L log L) sorted sweep it replaced
  (kept as the ``sort`` mode) and the O(L²) fold both other
  paths pay.  See :func:`_compile_union_sweep`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ptx.core import linalg
from ptx.core.constants import EPS, MAX_VALUE
from ptx.geom import tape

# numpy scalar, not jnp: importing ptx must not initialize the XLA backend
_PAD_T = np.float32(3e20)

# dense path above this leaf count pays quadratic memory; switch to the
# candidate-blocked scan (tunable per compile via candidate_block).  Its
# (2L, L, B) compare tensors reach ~4 GB at L=128 × B=131k render
# chunks, so the default stays memory-safe at 64.
_DENSE_L_MAX = 64
_DEFAULT_CANDIDATE_BLOCK = 32

# union-decomposable tapes above this leaf count route to the
# union sweep (O(L·hops) vs the dense/blocked O(L²) fold); below it the
# dense fold wins on constant factors.
_SWEEP_L_MIN = 24
# a top-level union operand ("group") may be a compound CSG gadget of up
# to this many leaves — its coverage intervals come from a small local
# membership fold (O(m²) per group, m bounded ⇒ total O(L·m)); bigger
# gadgets push the whole tape to the candidate-blocked path.
_SWEEP_GROUP_MAX = 12


def tape_is_union_only(plan) -> bool:
    """True iff every internal node of the tape is a union — the shape the
    reference's ``unionArray`` builder produces for arbitrary-scale scenes
    (/root/reference/src/test.cpp:52-64).  Nested unions are still one
    flat union semantically, which is what the sweep path exploits."""
    if isinstance(plan, tape._LeafPlan):
        return True
    return plan.op == "union" and all(
        tape_is_union_only(c) for c in plan.children)


def union_decompose(plan):
    """Split the tape into its maximal top-level union operands
    ("groups"): leaves and non-union-rooted subtrees.  A big scene built
    the reference way — ``unionArray`` over gadgets that are themselves
    small CSG solids (lenses, bulbs; test.cpp:52-64,126-144) — decomposes
    into many small groups, which is what the group sweep scales over."""
    groups = []

    def walk(node):
        if (not isinstance(node, tape._LeafPlan)) and node.op == "union":
            for c in node.children:
                walk(c)
        else:
            groups.append(node)

    walk(plan)
    return groups


def collect_leaves(plan):
    """Flatten the tape to (leaf, difference-parity) pairs, in REVERSED
    depth-first walk order.

    The order is the *coincident-boundary tie-break*: when two leaves share
    a boundary at exactly the same ``t`` (the reference demo unions a
    diffuse sphere with an identically-placed emissive core inside its
    glass bulb, test.cpp:131-132), the payload must come from the leaf the
    reference's nested two-stream merges would surface.  Tracing
    ``UnionSpanIterator::next`` (union.cpp:105-133) on identical spans:
    neither strict comparison fires, ``nextA()`` exhausts the first
    operand, and the SECOND operand's span is emitted — so the later
    operand wins union ties, recursively.  Reversing the walk order makes
    every argmin/first-wins selection below reproduce that (validated
    against the live reference binary — BASELINE.md 'Golden parity').
    Intersections of *identical* solids tie the other way in the
    reference; that degenerate authoring case is not reproduced."""
    leaves = []

    def walk(node, parity):
        if isinstance(node, tape._LeafPlan):
            leaves.append((node, parity))
        elif node.op == "difference":
            walk(node.children[0], parity)
            walk(node.children[1], -parity)
        else:
            for c in node.children:
                walk(c, parity)

    walk(plan, 1.0)
    leaves.reverse()
    return leaves


def _leaf_intervals(leaves, params, ox, oy, oz, dx, dy, dz,
                    with_normals=True):
    """Per-leaf boundary intervals, batch-minor SoA.

    Every per-ray quantity is kept as (B,)-component vectors and
    structural axes (leaf, candidate) lead, so the batch is the
    contiguous minor axis of every (2L, L, B) compare tensor instead of
    a 13-wide minor dim.

    Returns ``(t0, t1)`` of shape (L, B) and, when ``with_normals``,
    the start/end normal component stacks ((L, B) × 3 each)."""
    t0s, t1s = [], []
    n0c = ([], [], [])
    n1c = ([], [], [])
    for lf, _p in leaves:
        lox, loy, loz, ldx, ldy, ldz = ox, oy, oz, dx, dy, dz
        nrm = None
        if lf.xform_chain:
            w = params["xform"][lf.xform_chain[0]]
            for i in lf.xform_chain[1:]:
                w = linalg.compose(w, params["xform"][i])
            w_inv = linalg.inverse(w)
            A, tvec = w_inv[:, :3], w_inv[:, 3]
            lox = A[0, 0] * ox + A[0, 1] * oy + A[0, 2] * oz + tvec[0]
            loy = A[1, 0] * ox + A[1, 1] * oy + A[1, 2] * oz + tvec[1]
            loz = A[2, 0] * ox + A[2, 1] * oy + A[2, 2] * oz + tvec[2]
            ldx = A[0, 0] * dx + A[0, 1] * dy + A[0, 2] * dz
            ldy = A[1, 0] * dx + A[1, 1] * dy + A[1, 2] * dz
            ldz = A[2, 0] * dx + A[2, 1] * dy + A[2, 2] * dz
            nrm = jnp.transpose(w_inv[:, :3])       # A^{-T}

        if lf.kind == "sphere":
            c = params["sphere_center"][lf.index]
            r = params["sphere_radius"][lf.index]
            ocx, ocy, ocz = lox - c[0], loy - c[1], loz - c[2]
            a = ldx * ldx + ldy * ldy + ldz * ldz
            b = ocx * ldx + ocy * ldy + ocz * ldz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = b * b - a * cc
            ok = (disc > EPS) & (a != 0.0)
            sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
            sa = jnp.where(a == 0.0, 1.0, a)
            t0 = (-b - sq) / sa
            t1 = (-b + sq) / sa
            if with_normals:
                inv_r = 1.0 / jnp.where(r == 0.0, 1.0, r)
                nx0 = (ocx + t0 * ldx) * inv_r
                ny0 = (ocy + t0 * ldy) * inv_r
                nz0 = (ocz + t0 * ldz) * inv_r
                nx1 = (ocx + t1 * ldx) * inv_r
                ny1 = (ocy + t1 * ldy) * inv_r
                nz1 = (ocz + t1 * ldz) * inv_r
        else:
            n = params["plane_normal"][lf.index]
            dplane = params["plane_d"][lf.index]
            inv_mag = 1.0 / jnp.sqrt(jnp.maximum(
                n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1e-30))
            divisor = ldx * n[0] + ldy * n[1] + ldz * n[2]
            numer = -dplane - (lox * n[0] + loy * n[1] + loz * n[2])
            safe_div = jnp.where(jnp.abs(divisor) < EPS * EPS, 1.0,
                                 divisor)
            t = numer / safe_div
            degenerate = (jnp.abs(divisor) < EPS * EPS) | (
                jnp.abs(t) >= MAX_VALUE)
            on_boundary = jnp.abs(numer) < EPS * EPS
            entering_half = divisor < 0.0
            full = degenerate & on_boundary
            ok = ~(degenerate & ~on_boundary)
            t0 = jnp.where(full, -MAX_VALUE,
                           jnp.where(entering_half, t, -MAX_VALUE))
            t1 = jnp.where(full, MAX_VALUE,
                           jnp.where(entering_half, MAX_VALUE, t))
            if with_normals:
                one = jnp.ones_like(t)
                nx0 = nx1 = n[0] * inv_mag * one
                ny0 = ny1 = n[1] * inv_mag * one
                nz0 = nz1 = n[2] * inv_mag * one

        if with_normals and nrm is not None:
            def xf(nx, ny, nz):
                wx = nrm[0, 0] * nx + nrm[0, 1] * ny + nrm[0, 2] * nz
                wy = nrm[1, 0] * nx + nrm[1, 1] * ny + nrm[1, 2] * nz
                wz = nrm[2, 0] * nx + nrm[2, 1] * ny + nrm[2, 2] * nz
                mag = jnp.sqrt(wx * wx + wy * wy + wz * wz)
                inv = 1.0 / jnp.where(mag == 0.0, 1.0, mag)
                return wx * inv, wy * inv, wz * inv
            nx0, ny0, nz0 = xf(nx0, ny0, nz0)
            nx1, ny1, nz1 = xf(nx1, ny1, nz1)

        t0s.append(jnp.where(ok, t0, _PAD_T))
        t1s.append(jnp.where(ok, t1, _PAD_T))
        if with_normals:
            for lst, v in zip(n0c, (nx0, ny0, nz0)):
                lst.append(v)
            for lst, v in zip(n1c, (nx1, ny1, nz1)):
                lst.append(v)
    st = lambda xs: jnp.stack(xs, axis=0)
    if not with_normals:
        return st(t0s), st(t1s)
    return (st(t0s), st(t1s),
            tuple(st(c) for c in n0c), tuple(st(c) for c in n1c))


def _leaf_intervals_grouped(leaves, params, ox, oy, oz, dx, dy, dz):
    """(L, B) boundary intervals (no normals) computed *group-batched*:
    untransformed spheres and planes each become ONE gathered, broadcast
    computation over their whole group instead of L separate op groups —
    O(1) program size in the group and a matmul-friendly layout.
    Transformed leaves fall back to the per-leaf path.  Results are
    returned in leaf order (semantically identical to
    ``_leaf_intervals(..., with_normals=False)``; cross-checked in
    tests/test_large_scenes.py via the sweep-vs-oracle tests)."""
    idx_s, idx_p, idx_o = [], [], []
    for i, (lf, _p) in enumerate(leaves):
        if lf.xform_chain:
            idx_o.append(i)
        elif lf.kind == "sphere":
            idx_s.append(i)
        else:
            idx_p.append(i)

    L = len(leaves)
    B = ox.shape[0]
    parts_t0, parts_t1, order = [], [], []

    if idx_s:
        gi = np.array([leaves[i][0].index for i in idx_s])
        c = params["sphere_center"][gi]                      # (Ls, 3)
        r = params["sphere_radius"][gi]                      # (Ls,)
        ocx = ox[None, :] - c[:, 0:1]
        ocy = oy[None, :] - c[:, 1:2]
        ocz = oz[None, :] - c[:, 2:3]
        a = (dx * dx + dy * dy + dz * dz)[None, :]           # (1, B)
        b = ocx * dx[None] + ocy * dy[None] + ocz * dz[None]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[:, None]
        disc = b * b - a * cc
        ok = (disc > EPS) & (a != 0.0)
        sq = jnp.sqrt(jnp.where(ok, disc, 1.0))
        sa = jnp.where(a == 0.0, 1.0, a)
        parts_t0.append(jnp.where(ok, (-b - sq) / sa, _PAD_T))
        parts_t1.append(jnp.where(ok, (-b + sq) / sa, _PAD_T))
        order += idx_s

    if idx_p:
        gi = np.array([leaves[i][0].index for i in idx_p])
        n = params["plane_normal"][gi]                       # (Lp, 3)
        dp = params["plane_d"][gi]                           # (Lp,)
        o_mat = jnp.stack([ox, oy, oz])                      # (3, B)
        d_mat = jnp.stack([dx, dy, dz])
        # precision=HIGHEST is CORRECTNESS, not tuning: a reduced-
        # precision f32 matmul (bf16 passes, or TF32 on GPU tensor cores)
        # gives plane boundaries ~0.1-0.4% error — which mis-orders close
        # box-corner entries and voids near-EPS ground exits.
        hp = jax.lax.Precision.HIGHEST
        divisor = jnp.matmul(n, d_mat, precision=hp)         # (Lp, B)
        numer = -dp[:, None] - jnp.matmul(n, o_mat, precision=hp)
        safe_div = jnp.where(jnp.abs(divisor) < EPS * EPS, 1.0, divisor)
        t = numer / safe_div
        degenerate = (jnp.abs(divisor) < EPS * EPS) | (
            jnp.abs(t) >= MAX_VALUE)
        on_boundary = jnp.abs(numer) < EPS * EPS
        entering_half = divisor < 0.0
        full = degenerate & on_boundary
        ok = ~(degenerate & ~on_boundary)
        t0 = jnp.where(full, -MAX_VALUE,
                       jnp.where(entering_half, t, -MAX_VALUE))
        t1 = jnp.where(full, MAX_VALUE,
                       jnp.where(entering_half, MAX_VALUE, t))
        parts_t0.append(jnp.where(ok, t0, _PAD_T))
        parts_t1.append(jnp.where(ok, t1, _PAD_T))
        order += idx_p

    if idx_o:
        t0, t1 = _leaf_intervals([leaves[i] for i in idx_o], params,
                                 ox, oy, oz, dx, dy, dz, with_normals=False)
        parts_t0.append(t0)
        parts_t1.append(t1)
        order += idx_o

    t0 = jnp.concatenate(parts_t0, axis=0)
    t1 = jnp.concatenate(parts_t1, axis=0)
    inv = np.empty(L, np.int32)
    inv[np.array(order)] = np.arange(L)
    return t0[inv], t1[inv]


def _bits_at(node, leaf_pos, bits):
    """Fold the boolean CSG tape over per-leaf membership bits of shape
    (..., L, B) → (..., B)."""
    if isinstance(node, tape._LeafPlan):
        return bits[..., leaf_pos[id(node)], :]
    kids = [_bits_at(c, leaf_pos, bits) for c in node.children]
    if node.op == "union":
        out = kids[0]
        for k in kids[1:]:
            out = out | k
        return out
    if node.op == "intersection":
        out = kids[0]
        for k in kids[1:]:
            out = out & k
        return out
    return kids[0] & ~kids[1]


def compile_fast_hit(plan, candidate_block: int | None = None,
                     sweep: bool | None = None,
                     sweep_mode: str = "fixpoint"):
    """Compile a tape plan (from tape.compile_geometry) into
    ``hit_fn(params, origin, dir) -> first-hit dict`` (same contract as
    ptx.integrate.trace.first_hit).

    Scaling: the dense path materializes (2L, L, B) compare tensors plus
    (L, B) normal stacks — perfect for the demo's L=13, quadratic-memory
    hostile at L≈100+.  Large union-decomposable tapes take the union
    sweep (:func:`_compile_union_sweep`, ``sweep_mode`` "fixpoint" or
    the sorted "sort" cross-check); other large tapes scan candidates in
    ``candidate_block``-size blocks with a running argmin — see module
    docstring.  ``sweep``/``candidate_block`` force a strategy (tests
    cross-check all of them against the span-merge oracle,
    tests/test_large_scenes.py)."""

    # ---- flatten leaves with difference-B parity -------------------------
    leaves = collect_leaves(plan)
    L = len(leaves)
    if sweep is None:
        groups = union_decompose(plan)
        gmax = max((1 if isinstance(g, tape._LeafPlan)
                    else len(collect_leaves(g))) for g in groups)
        sweep = (candidate_block is None and L > _SWEEP_L_MIN
                 and len(groups) > 1 and gmax <= _SWEEP_GROUP_MAX)
    if sweep:
        return _compile_union_sweep(plan, leaves, sweep_mode=sweep_mode)
    if candidate_block is None and L > _DENSE_L_MAX:
        candidate_block = _DEFAULT_CANDIDATE_BLOCK
    if candidate_block:
        return _compile_blocked_hit(plan, leaves, candidate_block)
    parity = jnp.asarray(np.array([p for _, p in leaves], np.float32))
    mat_ids = jnp.asarray(np.array([lf.mat_id for lf, _ in leaves], np.int32))

    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}

    def hit_fn(params, origin, direction):
        """Sort-free first hit (see module docstring), batch-minor layout.

        Every leaf boundary time is a *candidate*; root membership just
        before (``t0 < t <= t1``) and just after (``t0 <= t < t1``) each
        candidate is evaluated independently and folded through the
        boolean tape; the first-hit walk (path-trace.h:66-99) reduces to
        the *minimum* root-membership transition with ``t >= EPS``.
        """
        batch_shape = origin.shape[:-1]
        flat = lambda a: a.reshape((-1,))
        ox, oy, oz = (flat(origin[..., i]) for i in range(3))
        dx, dy, dz = (flat(direction[..., i]) for i in range(3))

        t0, t1, (n0x, n0y, n0z), (n1x, n1y, n1z) = _leaf_intervals(
            leaves, params, ox, oy, oz, dx, dy, dz)

        t_evt = jnp.concatenate([t0, t1], axis=0)               # (2L, B)
        ts = t_evt[:, None, :]                                   # (2L, 1, B)
        lo = t0[None, :, :]                                      # (1, L, B)
        hi = t1[None, :, :]
        after = (lo <= ts) & (ts < hi)                           # (2L, L, B)
        before = (lo < ts) & (ts <= hi)

        root_after = _bits_at(plan, leaf_pos, after)             # (2L, B)
        root_before = _bits_at(plan, leaf_pos, before)
        candidate = (root_after != root_before) & (t_evt >= EPS)

        t_masked = jnp.where(candidate, t_evt, _PAD_T)
        idx = jax.lax.stop_gradient(jnp.argmin(t_masked, axis=0))  # (B,)
        any_trigger = jnp.any(candidate, axis=0)

        take = lambda a: jnp.take_along_axis(a, idx[None, :], axis=0)[0]
        t_hit = take(t_evt)
        escaped = t_hit >= MAX_VALUE
        hit = any_trigger & ~escaped
        entering = take(root_after)    # inside just after ⇒ entry boundary

        leaf_idx = idx % L
        nx = take(jnp.concatenate([n0x, n1x], axis=0))
        ny = take(jnp.concatenate([n0y, n1y], axis=0))
        nz = take(jnp.concatenate([n0z, n1z], axis=0))
        sign = parity[leaf_idx] * jnp.where(entering, 1.0, -1.0)
        normal = jnp.stack([nx * sign, ny * sign, nz * sign], axis=-1)
        mat_id = mat_ids[leaf_idx]

        unflat = lambda a: a.reshape(batch_shape)
        return {
            "t": unflat(jnp.where(hit, t_hit, 0.0)),
            "normal": normal.reshape(batch_shape + (3,)),
            "mat_id": jax.lax.stop_gradient(
                unflat(jnp.where(hit, mat_id, 0))),
            "entering": unflat(entering),
            "hit": unflat(hit),
            # winning event index (leaf + start/end) — the decision the
            # manual bounce VJP replays (ptx.geom.hitreplay)
            "_evt": unflat(jnp.where(hit, idx, 0).astype(jnp.int32)),
        }

    return hit_fn


def _compile_blocked_hit(plan, leaves, block: int):
    """Candidate-blocked first hit for large leaf counts (module docstring
    strategy 2).  Same decision semantics as the dense path; the winning
    normal comes from the selected-leaf replay instead of (L, B) stacks."""
    from ptx.geom import hitreplay

    L = len(leaves)
    parity_np = np.array([p for _, p in leaves], np.float32)
    mat_ids = jnp.asarray(np.array([lf.mat_id for lf, _ in leaves], np.int32))
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
    replay = hitreplay.build_hit_replay(leaves, parity_np)

    n_evt = 2 * L
    n_blocks = -(-n_evt // block)
    pad = n_blocks * block - n_evt

    def hit_fn(params, origin, direction):
        batch_shape = origin.shape[:-1]
        flat = lambda a: a.reshape((-1,))
        ox, oy, oz = (flat(origin[..., i]) for i in range(3))
        dx, dy, dz = (flat(direction[..., i]) for i in range(3))
        B = ox.shape[0]

        t0, t1 = _leaf_intervals_grouped(leaves, params,
                                         ox, oy, oz, dx, dy, dz)
        t_evt = jnp.concatenate([t0, t1], axis=0)                # (2L, B)
        if pad:
            t_evt_p = jnp.concatenate(
                [t_evt, jnp.full((pad, B), _PAD_T)], axis=0)
        else:
            t_evt_p = t_evt
        blocks = t_evt_p.reshape(n_blocks, block, B)
        # selection is discrete; keep the scanned compare tensors out of
        # the autodiff graph entirely (gradients flow via the replay)
        t0s = jax.lax.stop_gradient(t0)
        t1s = jax.lax.stop_gradient(t1)
        blocks = jax.lax.stop_gradient(blocks)

        def step(carry, blk):
            blk_idx, best_t, best_i, best_after, any_c = carry
            ts = blk[:, None, :]                                 # (C, 1, B)
            lo = t0s[None, :, :]
            hi = t1s[None, :, :]
            after = (lo <= ts) & (ts < hi)                       # (C, L, B)
            before = (lo < ts) & (ts <= hi)
            root_after = _bits_at(plan, leaf_pos, after)         # (C, B)
            root_before = _bits_at(plan, leaf_pos, before)
            cand = (root_after != root_before) & (blk >= EPS)
            tm = jnp.where(cand, blk, _PAD_T)
            loc = jnp.argmin(tm, axis=0)                         # (B,)
            take = lambda a: jnp.take_along_axis(a, loc[None, :], axis=0)[0]
            bt = take(tm)
            better = bt < best_t
            best_t = jnp.where(better, bt, best_t)
            best_i = jnp.where(better, blk_idx * block + loc, best_i)
            best_after = jnp.where(better, take(root_after), best_after)
            any_c = any_c | jnp.any(cand, axis=0)
            return (blk_idx + 1, best_t, best_i, best_after, any_c), None

        init = (jnp.int32(0),
                jnp.full((B,), _PAD_T),
                jnp.zeros((B,), jnp.int32),
                jnp.zeros((B,), bool),
                jnp.zeros((B,), bool))
        (_, best_t, best_i, entering, any_c), _ = jax.lax.scan(
            step, init, blocks)

        escaped = best_t >= MAX_VALUE
        hit = any_c & ~escaped
        evt = jnp.where(hit, best_i, 0)

        # winner payload: differentiable t + normal via selected-leaf replay
        t_rep, normal = replay(params, origin.reshape(-1, 3),
                               direction.reshape(-1, 3), evt, entering, hit)
        leaf_idx = jnp.where(evt >= L, evt - L, evt)
        mat_id = mat_ids[leaf_idx]

        unflat = lambda a: a.reshape(batch_shape)
        return {
            "t": unflat(t_rep),
            "normal": normal.reshape(batch_shape + (3,)),
            "mat_id": jax.lax.stop_gradient(
                unflat(jnp.where(hit, mat_id, 0))),
            "entering": unflat(entering),
            "hit": unflat(hit),
            "_evt": unflat(evt.astype(jnp.int32)),
        }

    return hit_fn


def _compile_union_sweep(plan, leaves, sweep_mode: str = "fixpoint"):
    """Sorted-interval sweep first hit for union-decomposable tapes
    (strategy 3) — ``Union(g₁ … g_K)`` where each group ``g`` is a leaf or
    a small CSG gadget (≤ _SWEEP_GROUP_MAX leaves): the reference's
    big-scene shape, ``unionArray`` over primitives AND compound solids
    (lenses/bulbs, test.cpp:52-64,126-144).

    Root membership at time ``t`` is interval coverage over the pooled
    *group* intervals: ``after(t) = ∃k: sₖ ≤ t < eₖ``.  Leaf groups
    contribute their primitive interval directly; a compound group's
    coverage intervals come from a LOCAL membership fold over just its
    own ``m`` leaves (two (2m, m, B) compare tensors + the group tape —
    O(m²) work, m bounded) followed by rank-pairing: coverage is a union
    of disjoint intervals, so the k-th smallest entry event pairs with
    the k-th smallest exit event.  Coincident boundary events inside a
    group classify identically (bits are a function of ``t`` alone), so
    duplicates are removed adjacent-equal after the sort to keep the
    pairing aligned.

    Sorting the pooled (valid) intervals by start collapses the global
    membership fold into prefix structure — no (2L, L) compare tensor:

    - ``P[k] = max(e of intervals sorted before k)`` (exclusive prefix
      max).  Interval ``k`` starts a NEW coverage chain iff ``s[k] > P[k]``
      (touching intervals, ``s == P``, merge — the union-coalescing rule);
      at such a *break* the prior chain ends exactly at ``P[k]``.
    - boundary candidates therefore live only at breaks: an exit at
      ``P[k]`` (if ≥ EPS) and an entry at ``s[k]`` (if ≥ EPS), plus the
      final chain's exit at the total max end.  The first-hit walk is the
      minimum candidate, exactly the dense path's
      ``argmin over (root_after != root_before) & (t ≥ EPS)``.

    Work per ray: O(L·m) local folds + one ≤L-key sort + one log-depth
    prefix scan — versus the O(L²) fold the dense/blocked paths pay.
    The default ``fixpoint`` mode drops the global sort as well (see its
    block comment).  Every boundary of the root solid is
    bitwise some leaf's ``t0``/``t1`` (sorts/max/min are value-preserving),
    so the winner's payload is recovered from the *unsorted* leaf
    intervals by equality match — min leaf index among starts first, then
    ends, which is the dense argmin's event-index tie-break (start events
    carry indices < L).  Selection is stop-gradient; the winner's
    differentiable ``t``/normal come from the selected-leaf replay
    (ptx.geom.hitreplay), as in the blocked path.
    """
    from ptx.geom import hitreplay

    L = len(leaves)
    parity_np = np.array([p for _, p in leaves], np.float32)
    mat_ids = jnp.asarray(np.array([lf.mat_id for lf, _ in leaves], np.int32))
    replay = hitreplay.build_hit_replay(leaves, parity_np)
    NEG = np.float32(-3e20)

    assert sweep_mode in ("fixpoint", "sort"), sweep_mode

    # compile-time group table: leaf groups batch into one direct slice;
    # compound groups batch BY STRUCTURE CLASS — same op tree ⇒ identical
    # membership fold, so all G instances run as ONE (G, 2m, m, B) fold +
    # ONE (G, 2m, B) sort per class instead of per-group ops (a 112-gadget
    # scene is 3 classes, not 112 op groups).
    leaf_pos = {id(lf): i for i, (lf, _) in enumerate(leaves)}
    leaf_rows = []
    classes: dict = {}          # structure sig → [rep_plan, rep_pos, [gidx]]

    def _sig(node, local_pos):
        if isinstance(node, tape._LeafPlan):
            return ("L", local_pos[id(node)])
        return (node.op, tuple(_sig(c, local_pos) for c in node.children))

    for g in union_decompose(plan):
        if isinstance(g, tape._LeafPlan):
            leaf_rows.append(leaf_pos[id(g)])
        else:
            sub = collect_leaves(g)
            gidx = np.array([leaf_pos[id(lf)] for lf, _ in sub])
            local_pos = {id(lf): j for j, (lf, _) in enumerate(sub)}
            key = _sig(g, local_pos)
            if key not in classes:
                classes[key] = [g, local_pos, []]
            classes[key][2].append(gidx)
    leaf_rows = np.array(leaf_rows, np.int32)
    compound = [(rep, pos, np.stack(gs).astype(np.int32))   # (G, m)
                for rep, pos, gs in classes.values()]

    def hit_fn(params, origin, direction):
        batch_shape = origin.shape[:-1]
        flat = lambda a: a.reshape((-1,))
        ox, oy, oz = (flat(origin[..., i]) for i in range(3))
        dx, dy, dz = (flat(direction[..., i]) for i in range(3))
        B = ox.shape[0]

        t0, t1 = _leaf_intervals_grouped(leaves, params,
                                         ox, oy, oz, dx, dy, dz)
        # selection is discrete — gradients flow only via the replay
        t0 = jax.lax.stop_gradient(t0)
        t1 = jax.lax.stop_gradient(t1)

        parts_s = [t0[leaf_rows]] if len(leaf_rows) else []
        parts_e = [t1[leaf_rows]] if len(leaf_rows) else []
        for gplan, local_pos, gidx_mat in compound:
            G, m = gidx_mat.shape
            gt0 = t0[gidx_mat.reshape(-1)].reshape(G, m, B)
            gt1 = t1[gidx_mat.reshape(-1)].reshape(G, m, B)
            ev = jnp.concatenate([gt0, gt1], axis=1)         # (G, 2m, B)
            ts = ev[:, :, None, :]                           # (G, 2m, 1, B)
            after = (gt0[:, None] <= ts) & (ts < gt1[:, None])
            before = (gt0[:, None] < ts) & (ts <= gt1[:, None])
            ra = _bits_at(gplan, local_pos, after)           # (G, 2m, B)
            rb = _bits_at(gplan, local_pos, before)
            bnd = ra != rb
            ent = jax.lax.sort(jnp.where(bnd & ra, ev, _PAD_T), dimension=1)
            exi = jax.lax.sort(jnp.where(bnd & ~ra, ev, _PAD_T), dimension=1)
            # coincident events all classify the same way — drop
            # adjacent-equal duplicates, re-sort to restore rank pairing
            dedup = lambda a: jax.lax.sort(jnp.concatenate(
                [a[:, :1],
                 jnp.where(a[:, 1:] == a[:, :-1], _PAD_T, a[:, 1:])],
                axis=1), dimension=1)
            parts_s.append(dedup(ent)[:, :m].reshape(G * m, B))
            parts_e.append(dedup(exi)[:, :m].reshape(G * m, B))
        s = jnp.concatenate(parts_s, axis=0)                 # (S, B), S ≤ L
        e = jnp.concatenate(parts_e, axis=0)

        # intervals ending before EPS can neither host nor cover any
        # qualifying candidate; zero-length ones are invisible to the
        # membership semantics (both bits flip inside one evaluation)
        valid = (s < e) & (e >= EPS)
        s = jnp.where(valid, s, _PAD_T)         # invalid sorts to the end
        e = jnp.where(valid, e, NEG)            # and never extends a chain

        if sweep_mode == "fixpoint":
            # Sort-free chain-exit selection — the production path.  The
            # sort only ever served to find the FIRST boundary ≥ EPS of
            # the coverage function, and that boundary has a closed form:
            #
            # - if no valid interval starts below EPS, coverage on
            #   [EPS, ∞) begins at the minimum start — every valid
            #   interval then has s ≥ EPS (valid ⇒ e ≥ EPS and s < e), so
            #   the first boundary is ``min s``, an ENTRY;
            # - otherwise every interval with s < EPS reaches past EPS
            #   (e ≥ EPS), so together they form ONE merged chain through
            #   EPS whose coverage is contiguous; the first boundary is
            #   that chain's EXIT, the fixed point of
            #   ``E ← max(E, max{e : s ≤ E})`` seeded from
            #   ``max{e : s < EPS}``.  Touching intervals (s == E) merge
            #   via the non-strict compare — the union-coalescing rule —
            #   and entries at s < E are covered, hence never boundaries.
            #
            # Each iteration extends E to the furthest end reachable in
            # one hop, so iterations = chain "hop diameter" (2-4 on real
            # scenes: a transmission ray sits inside one gadget), each a
            # fused masked max over (S, B) — one HBM pass — versus the
            # sort's ~log²S passes.  Termination is guaranteed: E strictly grows
            # for some ray every iteration and takes values from the
            # finite end set.  Selection is already stop-gradient.
            has_below = jnp.any(s < EPS, axis=0)              # (B,)
            t_entry = jnp.min(s, axis=0)                      # PAD if none
            E0 = jnp.max(jnp.where(s < EPS, e, NEG), axis=0)

            def _ext(E):
                return jnp.maximum(E, jnp.max(
                    jnp.where(s <= E[None, :], e, NEG), axis=0))

            def _cond(c):
                return ~c[1]

            def _body(c):
                E, _ = c
                En = _ext(E)
                return En, jnp.all(En == E)

            E, _ = jax.lax.while_loop(_cond, _body,
                                      (E0, jnp.array(False)))

            t_star = jnp.where(has_below, E, t_entry)
            entering = ~has_below
            found = t_star < 2e20
            lf = jnp.arange(L, dtype=jnp.int32)[:, None]
            m_start = jnp.min(
                jnp.where(t0 == t_star[None, :], lf, L), axis=0)
            m_end = jnp.min(
                jnp.where(t1 == t_star[None, :], lf, L), axis=0)
        else:
            # leaf identity does NOT ride the sort or the scan: the
            # winner's leaf is recovered afterwards from the UNSORTED
            # intervals (one fused reduce) — t_star passes through
            # max/min only, so the equality test below is bitwise-exact.
            # Keeps the sort 2-operand and the prefix scan 1-operand
            # (each (L, B) operand is ~67 MB of HBM traffic per pass at
            # render batch sizes).
            s_s, e_s = jax.lax.sort((s, e), dimension=0, num_keys=1,
                                    is_stable=True)
            inc_e = jax.lax.associative_scan(jnp.maximum, e_s, axis=0)
            P_e = jnp.concatenate([jnp.full((1, B), NEG), inc_e[:-1]],
                                  axis=0)

            is_break = (s_s < 2e20) & (s_s > P_e)
            # entry candidate at each break's start, exit candidate at
            # each break's prior-chain end, plus the final chain's exit
            te = jnp.min(jnp.where(is_break & (s_s >= EPS), s_s, _PAD_T),
                         axis=0)
            tx = jnp.min(jnp.where(is_break & (P_e >= EPS), P_e, _PAD_T),
                         axis=0)
            tx = jnp.minimum(
                tx, jnp.where(inc_e[-1] >= EPS, inc_e[-1], _PAD_T))

            # an entry and an exit can only collide at unequal breaks
            # where the entry came first — dense resolves the same way
            # (entry events carry the lower indices)
            entering = te <= tx
            t_star = jnp.minimum(te, tx)
            found = t_star < 2e20

            # winner's payload: min leaf whose raw start (then end)
            # equals t_star.  Every event at exactly t_star is a dense
            # candidate (membership bits are a function of t alone, and
            # the root flips at t_star), so this IS the dense argmin's
            # event-index tie-break: start events carry indices < L, so
            # any start match beats every end match.  In compound groups
            # an ENTERING root boundary can be generated by a leaf's END
            # event (a difference's cut surface takes B's boundary,
            # span.h:100-112) — which the evt encoding (leaf vs L+leaf)
            # captures independently of ``entering``.
            lf = jnp.arange(L, dtype=jnp.int32)[:, None]
            m_start = jnp.min(
                jnp.where(t0 == t_star[None, :], lf, L), axis=0)
            m_end = jnp.min(
                jnp.where(t1 == t_star[None, :], lf, L), axis=0)

        escaped = t_star >= MAX_VALUE
        hit = found & ~escaped
        use_start = m_start < L
        leaf_star = jnp.where(use_start, m_start, jnp.minimum(m_end, L - 1))
        evt = jnp.where(hit, jnp.where(use_start, leaf_star, L + leaf_star),
                        0).astype(jnp.int32)

        t_rep, normal = replay(params, origin.reshape(-1, 3),
                               direction.reshape(-1, 3), evt, entering, hit)
        mat_id = mat_ids[jnp.where(evt >= L, evt - L, evt)]

        unflat = lambda a: a.reshape(batch_shape)
        return {
            "t": unflat(t_rep),
            "normal": normal.reshape(batch_shape + (3,)),
            "mat_id": jax.lax.stop_gradient(
                unflat(jnp.where(hit, mat_id, 0))),
            "entering": unflat(entering),
            "hit": unflat(hit),
            "_evt": unflat(evt),
        }

    return hit_fn
