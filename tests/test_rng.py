"""RNG: reference-LCG bit-exactness and sampler distributions."""

import numpy as np
import jax
import jax.numpy as jnp

from ptx.core import rng


def _lcg_bigint(seed, count):
    """Independent big-int re-derivation of the reference stream
    (path-trace.h:36-44): v = (214013·v + 2531011) mod 2^64, output = high
    32 bits, seed XOR 0x12476242."""
    v = (seed ^ 0x12476242) & 0xFFFFFFFFFFFFFFFF
    out = []
    for _ in range(count):
        v = (214013 * v + 2531011) & 0xFFFFFFFFFFFFFFFF
        out.append(v >> 32)
    return out


def test_reference_lcg_stream_matches_bigint():
    for seed in (0, 1, 0xDEADBEEF):
        eng = rng.ReferenceLCG(seed)
        want = _lcg_bigint(seed, 64)
        got = [eng() for _ in range(64)]
        assert got == want
        np.testing.assert_array_equal(
            rng.lcg_stream(seed, 64), np.array(want, np.uint32))


def test_reference_lcg_discard():
    a = rng.ReferenceLCG(7)
    b = rng.ReferenceLCG(7)
    a.discard(10)
    for _ in range(10):
        b()
    assert a() == b()


def test_reference_lcg_uniform_range():
    eng = rng.ReferenceLCG(3)
    vals = [eng.uniform(-1.0, 1.0) for _ in range(200)]
    assert all(-1.0 <= v <= 1.0 for v in vals)
    assert abs(np.mean(vals)) < 0.2


def test_unit_ball_distribution():
    """Uniform-in-ball: |v| ≤ 1, E[v]=0, E[|v|²]=3/5."""
    key = jax.random.PRNGKey(0)
    v = np.asarray(rng.sample_unit_ball(key, (20000,)))
    r = np.linalg.norm(v, axis=-1)
    assert r.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=0.02)
    np.testing.assert_allclose((r ** 2).mean(), 0.6, atol=0.02)
    # radius^3 uniform in [0,1]
    np.testing.assert_allclose(np.sort(r ** 3)[10000], 0.5, atol=0.03)


def test_fold_decorrelates():
    key = jax.random.PRNGKey(1)
    a = np.asarray(jax.random.uniform(rng.fold(key, 0), (100,)))
    b = np.asarray(jax.random.uniform(rng.fold(key, 1), (100,)))
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.3
    assert not np.array_equal(a, b)


def test_scatter_selection_matches_reference_on_lcg_streams():
    """Drive BOTH the vectorized scatter selection (select_scatter_dir)
    and a scalar transcription of the reference's rejection loops
    (vector3d.h:163-185 ball sampler + path-trace.h:138-158 accept loop)
    with the SAME ReferenceLCG draw stream: the accepted direction must
    match draw-for-draw.  This validates the sampling *logic* against the
    C++ with matched streams, not just the LCG."""
    from ptx.core.constants import EPS
    from ptx.core.rng import ReferenceLCG
    from ptx.integrate.trace import select_scatter_dir

    def reflect(d, n):
        n = n / np.linalg.norm(n)
        return (d - 2 * np.dot(d, n) * n).astype(np.float32)

    def reference_scatter(lcg, d, n, sc, max_draw_triples):
        """Scalar transcription of the reference loops; also returns the
        cube-draw triples it consumed so the vector path sees the exact
        same stream."""
        draws = []
        reflected = reflect(d, n)
        resulting = reflected.copy()
        count = 0
        while True:
            count += 1
            assert count <= 1000
            # Vector3D::rand(r, 1, 0): cube rejection until inside ball
            while True:
                v = np.array([lcg.uniform(-1, 1), lcg.uniform(-1, 1),
                              lcg.uniform(-1, 1)], np.float32)
                draws.append(v)
                assert len(draws) <= max_draw_triples
                if np.sqrt(np.sum(v * v)) <= 1.0:
                    break
            resulting = v + np.float32(1.0 / sc - 1.0) * reflected
            if np.dot(n, resulting) > EPS:
                break
        out = resulting / np.linalg.norm(resulting)
        return out.astype(np.float32), draws

    g = np.random.default_rng(7)
    T = 64
    checked = 0
    for case in range(40):
        d = g.normal(size=3).astype(np.float32)
        d /= np.linalg.norm(d)
        n = g.normal(size=3).astype(np.float32)
        n /= np.linalg.norm(n)
        if np.dot(d, n) > -0.05:         # need a surface the ray enters
            n = -np.sign(np.dot(d, n)) * n
        sc = float(g.uniform(0.05, 1.0))
        lcg = ReferenceLCG(seed=1234 + case)
        try:
            want, draws = reference_scatter(lcg, d, n, sc, T)
        except AssertionError:
            continue                      # pathological case: skip
        # replay the SAME stream through the vector path
        u = np.zeros((T, 3), np.float32)
        u[:len(draws)] = np.stack(draws)
        # unused tail: fill with in-ball-failing draws so they can't win
        u[len(draws):] = 2.0
        got, ok, _raw = select_scatter_dir(
            jnp.asarray(u)[None], jnp.asarray(d)[None],
            jnp.asarray(n)[None], jnp.asarray([sc]), return_raw=True)
        assert bool(np.asarray(ok)[0])
        np.testing.assert_allclose(np.asarray(got)[0], want,
                                   rtol=2e-5, atol=2e-6)
        checked += 1
    assert checked >= 30
