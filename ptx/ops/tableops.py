"""Table-lookup primitives with one-hot-contraction transposes.

``table[idx]`` is a row gather; XLA transposes it to a scatter-add into
the table, where every lane of the wavefront lands on one of a few rows.
For the small parameter tables this framework gathers from on every
bounce (material constant rows, per-material ior, packed leaf-geometry
rows: tens to hundreds of rows), :func:`table_lookup` keeps the cheap
gather forward but hand-writes the backward as ``one_hot(idx)ᵀ @ ct`` —
a dense (R, B) × (B, P) contraction instead of a many-way-colliding
scatter.  Only suitable for SMALL row counts (the one-hot is
materialized as (B, R) — keep R ≲ 1k); large tables (texture images)
keep the scatter transpose.  Every contraction is ``Precision.HIGHEST``:
a reduced-precision f32 matmul (bf16 passes, TF32) rounds each
cotangent before accumulating.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def table_lookup_aug(table, aux, idx, onehot_fwd=False):
    """Row lookup into ``concat([table, aux], axis=1)`` for a (R, C)
    differentiable ``table`` and (R, A) CONSTANT ``aux`` columns, fused
    so the whole per-lane fetch is ONE memory op.

    Separate fetches of narrow constant columns would each be a per-lane
    gather of their own, and a plain ``concatenate`` before the gather
    leaves autodiff a (R, C+A) ``split`` transpose — here the backward
    slices the first C columns inside the custom VJP instead.

    ``onehot_fwd`` replaces the forward gather with
    ``one_hot(idx) @ table`` (precision HIGHEST): a (B, R) x (R, C+A)
    contraction that reads the one-hot (~4RB bytes) instead of gathering
    per row.  Only worth it when R is small (the one-hot is
    materialized)."""
    full = jnp.concatenate([table, aux], axis=1)
    return full[idx]


def _aug_fwd(table, aux, idx, onehot_fwd):
    full = jnp.concatenate([table, aux], axis=1)
    if onehot_fwd:
        idx_flat = idx.reshape(-1)
        oh = jax.nn.one_hot(idx_flat, full.shape[0], dtype=full.dtype)
        out = jax.lax.dot_general(
            oh, full, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        out = out.reshape(idx.shape + (full.shape[1],))
    else:
        out = full[idx]
    return out, (table.shape, idx)


def _aug_bwd(onehot_fwd, res, ct):
    shape, idx = res
    R, C = shape
    idx_flat = idx.reshape(-1)
    ct_flat = ct.reshape(idx_flat.shape[0], ct.shape[-1])
    oh = jax.nn.one_hot(idx_flat, R, dtype=ct_flat.dtype)      # (B, R)
    d_full = jax.lax.dot_general(
        oh, ct_flat, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)                    # (R, C+A)
    return d_full[:, :C], None, None


table_lookup_aug.defvjp(_aug_fwd, _aug_bwd)


@jax.custom_vjp
def table_lookup(table, idx):
    """``table[idx]`` for a (R, ...) table and integer ``idx`` of any
    shape; gradient w.r.t. ``table`` accumulates via a one-hot matmul."""
    return table[idx]


def _fwd(table, idx):
    return table[idx], (table.shape, idx)


def _bwd(res, ct):
    shape, idx = res
    R = shape[0]
    payload = 1
    for s in shape[1:]:
        payload *= s
    idx_flat = idx.reshape(-1)
    ct_flat = ct.reshape(idx_flat.shape[0], payload)
    oh = jax.nn.one_hot(idx_flat, R, dtype=ct_flat.dtype)      # (B, R)
    # HIGHEST is correctness: at default precision a matmul unit rounds
    # each cotangent (bf16 passes, or TF32 on GPU tensor cores) before
    # accumulating — ~0.4% per term; the one-hot side alone being exact
    # does not save the values
    d_table = jax.lax.dot_general(
        oh, ct_flat, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)                    # (R, P)
    return d_table.reshape(shape), None


table_lookup.defvjp(_fwd, _bwd)
