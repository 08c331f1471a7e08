"""Unit gates for ptx.ops.tableops — the table-lookup primitives every
hot path rides (material rows, replay leaf rows, emission slots).

Forward must equal plain ``table[idx]`` bit-for-bit in BOTH forward
modes (the one-hot matmul fetch at HIGHEST reproduces f32 exactly: each
output element is a single 1.0·x product), and the hand-written
backward must match autodiff of the plain gather.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.ops.tableops import table_lookup, table_lookup_aug


def _fixtures(R=37, C=5, A=2, B=513, seed=0):
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.normal(size=(R, C)).astype(np.float32) * 3.7)
    aux = jnp.asarray(rng.normal(size=(R, A)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, R, B).astype(np.int32))
    ct = jnp.asarray(rng.normal(size=(B, C + A)).astype(np.float32))
    return table, aux, idx, ct


def test_table_lookup_forward_and_backward():
    table, _, idx, ct = _fixtures()
    out = table_lookup(table, idx)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(table)[np.asarray(idx)])

    ctc = ct[:, :table.shape[1]]
    f_manual = lambda t: jnp.vdot(table_lookup(t, idx), ctc)
    f_auto = lambda t: jnp.vdot(t[idx], ctc)
    gm = jax.grad(f_manual)(table)
    ga = jax.grad(f_auto)(table)
    np.testing.assert_allclose(np.asarray(gm), np.asarray(ga),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("onehot", [False, True])
def test_table_lookup_aug_matches_concat_gather(onehot):
    table, aux, idx, ct = _fixtures()
    full = jnp.concatenate([table, aux], axis=1)
    ref = np.asarray(full)[np.asarray(idx)]
    out = table_lookup_aug(table, aux, idx, onehot)
    # bit-exact in BOTH modes: the one-hot dot at HIGHEST is a single
    # exact 1.0·x product per element
    np.testing.assert_array_equal(np.asarray(out), ref)

    # backward: d_table only (aux is const), equal to autodiff of the
    # concat+gather composition's table component
    f_manual = lambda t: jnp.vdot(table_lookup_aug(t, aux, idx, onehot),
                                  ct)
    f_auto = lambda t: jnp.vdot(
        jnp.concatenate([t, aux], axis=1)[idx], ct)
    gm = jax.grad(f_manual)(table)
    ga = jax.grad(f_auto)(table)
    np.testing.assert_allclose(np.asarray(gm), np.asarray(ga),
                               rtol=1e-5, atol=1e-5)


def test_table_lookup_aug_multi_dim_idx_and_empty_aux():
    table, _, _, _ = _fixtures()
    R = table.shape[0]
    rng = np.random.default_rng(3)
    idx = jnp.asarray(rng.integers(0, R, (7, 11)).astype(np.int32))
    aux0 = jnp.zeros((R, 0), jnp.float32)      # materials._mat_slot_lookup
    out = table_lookup_aug(table, aux0, idx, True)
    assert out.shape == idx.shape + (table.shape[1],)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(table)[np.asarray(idx)])
    g = jax.grad(lambda t: jnp.sum(
        table_lookup_aug(t, aux0, idx, True) ** 2))(table)
    assert np.isfinite(np.asarray(g)).all()
