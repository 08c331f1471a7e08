"""The accelerator path is plain JAX/XLA, and the entry points treat the
device honestly.

- Every built-in scene's forward+backward ``trace_rays`` graph contains
  no ``pallas_call``, and every ``dot_general`` in it asks for
  ``Precision.HIGHEST``: on a GPU a default-precision float32 dot runs
  in TF32 (~3 decimal digits), which misorders close geometry
  boundaries and rounds gradients.
- The compile-cache helper honours ``JAX_COMPILATION_CACHE_DIR`` and
  otherwise uses one fixed, gitignored path inside the checkout.
- ``chip_smoke.py`` fails, printing no result, where there is no GPU or
  no ``ptx`` package beside it.
- ``ptx farm`` assembles a frame without importing JAX, so it never
  opens a card that a ``ptx serve`` process holds.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.integrate.trace import compile_scene, trace_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(name):
    from ptx.scenes import builders
    if name == "composed":
        from ptx.scenes.spec import SceneSpec
        return SceneSpec.load(os.path.join(ROOT, "scenes",
                                           "composed.json")).build()[0]
    if name == "stress":
        return builders.stress_spheres(32, transformed=True)
    return {"demo": builders.make_world,
            "config1": builders.baseline_config1,
            "config2": builders.baseline_config2,
            "config3": builders.baseline_config3,
            "config4": builders.baseline_config4}[name]()


def _walk(jaxpr, counts):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        counts[name] = counts.get(name, 0) + 1
        if name == "dot_general":
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec, prec)
            assert all(p == jax.lax.Precision.HIGHEST for p in precs), (
                f"dot_general at default precision: {eqn}")
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, "eqns"):
                    _walk(sub, counts)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    _walk(sub.jaxpr, counts)


@pytest.mark.parametrize("name", ["demo", "config1", "config2", "config3",
                                  "config4", "composed", "stress"])
def test_trace_graph_is_plain_xla_at_highest_precision(name):
    scene = compile_scene(_scene(name))
    g = np.random.default_rng(0)
    o = jnp.asarray(np.zeros((64, 3), np.float32))
    d = jnp.asarray(np.stack([g.uniform(-0.5, 0.5, 64),
                              g.uniform(-0.5, 0.5, 64),
                              -np.ones(64)], -1).astype(np.float32))
    key = jax.random.PRNGKey(0)

    def loss(p):
        return jnp.mean(trace_rays(scene, p, o, d, key, depth=8,
                                   compact=True))

    counts = {}
    _walk(jax.make_jaxpr(jax.value_and_grad(loss))(scene.params).jaxpr,
          counts)
    assert "pallas_call" not in counts
    assert counts.get("scan", 0) > 0          # the bounce loop was walked
    # the material-table transposes are one-hot contractions, so every
    # scene's backward carries dot_generals for the guard to check
    assert counts.get("dot_general", 0) > 0


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from ptx.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_gitignored_path(monkeypatch):
    from ptx.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_render_phase_rejects_a_cpu_render(tmp_path,
                                                      monkeypatch):
    # the CLI child chooses its own backend; a render that fell back to
    # the CPU must fail the phase even though its frame is fine
    import chip_smoke
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    res = chip_smoke._render_phase(
        ["render", "--demo", "demo", "--width", "8", "--height", "8",
         "--spp", "1", "--depth", "1"], (8, 8), str(tmp_path / "r"))
    assert res["platform"] == "cpu"
    assert res["frame"]["ok"]
    assert not res["ok"]


def test_farm_client_never_imports_jax(tmp_path):
    from ptx.runtime import RenderFarmServer, runtime_available
    if not runtime_available():
        pytest.skip("native toolchain unavailable")

    def render_fn(x0, y0, w, h, spp, depth, seed):
        return np.full((h, w, 3), 0.25, np.float32)

    client = ("import sys; from ptx import cli; cli.main(sys.argv[1:]); "
              "assert 'jax' not in sys.modules, 'farm client imported jax'")
    with RenderFarmServer(render_fn, port=0, threads=2) as srv:
        proc = subprocess.run(
            [sys.executable, "-c", client, "farm", f"127.0.0.1:{srv.port}",
             "--width", "16", "--height", "16", "--tile", "8", "--spp", "1",
             "--depth", "1", "--out", str(tmp_path / "f")],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "(4/4 tiles)" in proc.stdout
    from ptx.io import hdr
    img = hdr.read(tmp_path / "f.hdr")
    np.testing.assert_allclose(img[..., :3], 0.25, rtol=1e-2)
