"""Material parameter table.

A material is 5 texture slots + an index of refraction
(``/root/reference/include/material.h:10-37``):

- ``reflect``: reflection tint
- ``scatter``: scatter coefficient, 0 = perfect mirror → 1 = fully diffuse
- ``emissive``: emitted radiance
- ``transmit``: transmission tint
- ``transmit_reflect``: 0 = reflect → 1 = transmit weighting
- ``ior``: scalar index of refraction (differentiable leaf)

The compiled table evaluates every material's slots at a batch of shading
points and gathers by material id — materials are few (the reference demo
has 10), each slot is cheap (a constant broadcast or one image gather), and
this keeps the wavefront free of data-dependent dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax.numpy as jnp

from ptx.shade import textures as tx


def _as_tex(v):
    if isinstance(v, (int, float)):
        return tx.Constant(float(v))
    if isinstance(v, (tuple, list, np.ndarray)):
        return tx.Constant(np.asarray(v, np.float32))
    return v


@dataclasses.dataclass(frozen=True, eq=False)
class Material:
    """Slot defaults mirror the reference constructor (material.h:18-21)."""
    reflect: Any = 1.0
    scatter: Any = 1.0
    emissive: Any = 0.0
    transmit: Any = 0.0
    ior: float = 1.0
    transmit_reflect: Any = 0.0

    def __post_init__(self):
        for f in ("reflect", "scatter", "emissive", "transmit",
                  "transmit_reflect"):
            object.__setattr__(self, f, _as_tex(getattr(self, f)))


def transform_material(A, mat: Material) -> Material:
    """``transform(Matrix, Material*)`` — transforms every texture slot's
    lookup coordinates; ior unchanged (material.h:39-42)."""
    return Material(
        reflect=tx.transform_texture(A, mat.reflect),
        scatter=tx.transform_texture(A, mat.scatter),
        emissive=tx.transform_texture(A, mat.emissive),
        transmit=tx.transform_texture(A, mat.transmit),
        ior=mat.ior,
        transmit_reflect=tx.transform_texture(A, mat.transmit_reflect),
    )


SLOTS = ("reflect", "scatter", "emissive", "transmit", "transmit_reflect")


def compile_material_table(materials_in_id_order, compiler: tx.TextureCompiler):
    """Compile materials → (params_contrib, eval_fn).

    ``eval_fn(params, pos, mat_id)`` evaluates all 5 slots at positions
    ``pos`` ``(..., 3)`` for per-ray material ids ``(...,)`` and returns a
    dict: color slots as ``(..., 3)``, plus scalar ``scatter_f`` /
    ``transmit_reflect_f`` (channel means, texture.h:14-18) and ``ior``.

    Constant slots (the vast majority — the demo scene has one image slot
    out of 30) resolve through a single (M,)-indexed gather into the
    differentiable constant table; only procedural/image slots evaluate
    per-ray, selected by material-id mask.  This keeps the per-bounce
    shading cost at ~#dynamic-slots gathers instead of M×5 evaluations.
    """
    M = len(materials_in_id_order)
    const_idx = {s: np.zeros(M, np.int64) for s in SLOTS}
    dynamic = {s: [] for s in SLOTS}        # (material_index, fn)
    zero_idx = None
    for mi, m in enumerate(materials_in_id_order):
        for s in SLOTS:
            texn = getattr(m, s)
            if isinstance(texn, tx.Constant):
                # compiler.compile(Constant) appends to the const table;
                # record its row for direct gathering
                row = len(compiler.params["const"])
                compiler.compile(texn)
                const_idx[s][mi] = row
            else:
                if zero_idx is None:
                    zero_idx = len(compiler.params["const"])
                    compiler.compile(tx.Constant(0.0))   # placeholder row
                const_idx[s][mi] = zero_idx
                dynamic[s].append((mi, compiler.compile(texn)))
    const_idx = {s: jnp.asarray(v) for s, v in const_idx.items()}
    iors = jnp.asarray(np.array([m.ior for m in materials_in_id_order], np.float32))

    from ptx.ops.tableops import table_lookup, table_lookup_aug
    _no_aux = np.zeros((M, 0), np.float32)

    def _mat_slot_lookup(params, mat_id, s):
        # Pre-gather the (M, 3) per-material slot table (tiny, STATIC
        # indices) so the wavefront pays ONE per-lane fetch instead of
        # two chained gathers (index indirection + const row), as a
        # one-hot contraction over the M rows.  Backward: one-hot
        # transpose to (M, 3), then the tiny static gather's scatter-add
        # into const.
        table = params["const"][const_idx[s]]                # (M, 3)
        return table_lookup_aug(table, jnp.asarray(_no_aux), mat_id,
                                True)

    def _slot_val(params, pos, mat_id, s):
        val = _mat_slot_lookup(params, mat_id, s)
        for mi, fn in dynamic[s]:
            dyn = fn(params, pos)
            val = jnp.where((mat_id == mi)[..., None], dyn, val)
        return val

    def eval_fn(params, pos, mat_id):
        # ONE packed per-material row gather instead of six: the 5 slots
        # + ior pre-pack into a (M, 16) table with a STATIC (M,)-row
        # gather per slot and the wavefront pays a single row lookup.
        packed = jnp.concatenate(
            [params["const"][const_idx[s]] for s in SLOTS]
            + [params["ior"][:, None]], axis=1)          # (M, 16)
        row = table_lookup(packed, mat_id)               # (..., 16)
        out = {}
        for i, s in enumerate(SLOTS):
            val = row[..., 3 * i:3 * i + 3]
            for mi, fn in dynamic[s]:
                dyn = fn(params, pos)
                val = jnp.where((mat_id == mi)[..., None], dyn, val)
            out[s] = val
        out["scatter_f"] = jnp.mean(out["scatter"], axis=-1)
        out["transmit_reflect_f"] = jnp.mean(out["transmit_reflect"], axis=-1)
        out["ior"] = row[..., 15]
        return out

    def eval_emissive(params, pos, mat_id):
        """Emissive slot only — trace_rays evaluates emission post-scan,
        apart from the other slots the bounce consumes."""
        return _slot_val(params, pos, mat_id, "emissive")

    # --- terminal dynamic-emissive materials ("sky shape") -------------
    # A material whose reflect AND transmit tints are the exact constant
    # zero kills the path's throughput on hit (trace._bounce_live: both
    # branch tints are 0 ⇒ throughput2 ≡ 0, and every later bounce's
    # emission contribution is exactly 0·em).  So a path has AT MOST ONE
    # bounce where (mat is terminal ∧ throughput ≠ 0) — which lets
    # trace_rays evaluate such a material's dynamic emissive chain on one
    # selected lane per path instead of every (bounce, path) lane.  That
    # is the load-bearing property for reference-scale sky probes (3k
    # equirect, test.cpp:123): their image gather and its scatter-add
    # transpose cost per LANE.
    def _const_zero(texn):
        return (isinstance(texn, tx.Constant)
                and not np.any(np.asarray(texn.color, np.float32)))

    terminal = {mi for mi, m in enumerate(materials_in_id_order)
                if _const_zero(m.reflect) and _const_zero(m.transmit)}
    terminal_dynamic_emissive = [(mi, fn) for mi, fn in dynamic["emissive"]
                                 if mi in terminal]
    _term_set = {mi for mi, _ in terminal_dynamic_emissive}

    def eval_emissive_base(params, pos, mat_id):
        """Emission WITHOUT the terminal dynamic chains: their lanes are
        masked to exact zero — masked, not just routed to the zero
        placeholder const row, because the placeholder is a shared
        differentiable table row and an unmasked lookup would leak those
        lanes' cotangents into it.  trace_rays adds the terminal chains
        back on per-path selected lanes (the sky-select path)."""
        val = _mat_slot_lookup(params, mat_id, "emissive")
        for mi, fn in dynamic["emissive"]:
            if mi in _term_set:
                continue
            dyn = fn(params, pos)
            val = jnp.where((mat_id == mi)[..., None], dyn, val)
        if _term_set:
            is_term = jnp.zeros(mat_id.shape, bool)
            for mi in _term_set:
                is_term = is_term | (mat_id == mi)
            val = jnp.where(is_term[..., None], 0.0, val)
        return val

    # metadata for trace_rays' emission routing: which const-table row
    # feeds each (material, slot), and which slots have any
    # position-dependent textures
    eval_fn.const_idx = const_idx
    eval_fn.dynamic_slots = {s: [mi for mi, _ in dynamic[s]] for s in SLOTS}
    eval_fn.n_materials = M
    eval_fn.eval_emissive = eval_emissive
    eval_fn.eval_emissive_base = eval_emissive_base
    eval_fn.terminal_dynamic_emissive = terminal_dynamic_emissive

    return {"ior": iors}, eval_fn


def assign_material_ids(root) -> tuple:
    """Walk a geometry tree collecting distinct materials in first-seen
    order.  Returns (ordered materials, {id(mat): index})."""
    from ptx.geom import tape

    ordered, ids = [], {}

    def visit(m):
        if id(m) not in ids:
            ids[id(m)] = len(ordered)
            ordered.append(m)

    def walk(node):
        if isinstance(node, tape.Sphere) or isinstance(node, tape.Plane):
            visit(node.material)
        elif isinstance(node, tape.Transformed):
            walk(node.obj)
        elif isinstance(node, (tape.Union, tape.Intersection)):
            for c in node.objects:
                walk(c)
        elif isinstance(node, tape.Difference):
            walk(node.a); walk(node.b)
        else:
            raise TypeError(f"unknown scene node {type(node)!r}")

    walk(root)
    return ordered, ids
