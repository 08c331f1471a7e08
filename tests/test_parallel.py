"""Sharding correctness on the virtual 8-device CPU mesh.

SURVEY §4: "assert bitwise-equal images for sharded vs unsharded runs" —
our invariant is mesh-shape independence: the same per-(tile, sample) RNG
fold sequence makes a 1×1 mesh and an 8-device mesh average the *same*
estimates when the shard-local keys line up; we assert statistical
equality (same scene, same totals) and exact determinism per mesh shape.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptx.integrate.camera import Camera
from ptx.integrate.trace import compile_scene
from ptx.parallel import checkpoint, mesh as pmesh
from ptx.parallel.render import make_train_step, render_sharded
from ptx.scenes.builders import baseline_config1


@pytest.fixture(scope="module")
def scene():
    return compile_scene(baseline_config1())


CAM = Camera(16, 16)


def test_render_sharded_deterministic(scene):
    m = pmesh.make_mesh(tiles=4, samples=2)
    key = jax.random.PRNGKey(0)
    a = np.asarray(render_sharded(scene, CAM, m, key, spp=4, depth=3))
    b = np.asarray(render_sharded(scene, CAM, m, key, spp=4, depth=3))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 16, 3) and np.isfinite(a).all()
    assert a.mean() > 0.01


def test_mesh_shapes_agree_statistically(scene):
    key = jax.random.PRNGKey(1)
    m82 = pmesh.make_mesh(tiles=4, samples=2)
    m18 = pmesh.make_mesh(tiles=1, samples=8)
    a = np.asarray(render_sharded(scene, CAM, m82, key, spp=8, depth=3))
    b = np.asarray(render_sharded(scene, CAM, m18, key, spp=8, depth=3))
    # different RNG partitions → different noise; means must agree within
    # Monte-Carlo error at spp=8 over 256 pixels
    assert abs(a.mean() - b.mean()) < 0.05
    assert np.isfinite(b).all()


def test_train_step_decreases_loss(scene):
    m = pmesh.make_mesh(tiles=8, samples=1)
    key = jax.random.PRNGKey(2)
    target = render_sharded(scene, CAM, m, key, spp=8, depth=3)

    # perturb a material constant and optimize back toward the target;
    # success = the parameter moves toward its true value (loss itself is
    # stochastic per step, so compare in parameter space)
    true_val = np.asarray(scene.params["const"])[0].copy()
    params = dict(scene.params)
    params["const"] = params["const"].at[0].add(0.5)
    d0 = float(np.abs(np.asarray(params["const"])[0] - true_val).sum())
    step = make_train_step(scene, CAM, m, spp=8, depth=3, learning_rate=2.0)
    losses = []
    for i in range(6):
        params, loss = step(params, target, jax.random.fold_in(key, i))
        losses.append(float(loss))
    d1 = float(np.abs(np.asarray(params["const"])[0] - true_val).sum())
    assert np.isfinite(losses).all()
    assert d1 < d0, (d0, d1, losses)


def test_compacted_manual_vjp_sharded_digest(scene):
    """The production trace configuration — phase
    compaction + the decision-frozen manual-VJP bounce — must produce the
    SAME image and the SAME parameter gradients inside shard_map as an
    explicit per-(tile, sample) loop of bare trace_rays calls.  This
    pins _compact_wavefront's orig_idx bookkeeping, the phase radiance
    scatter, and the custom-VJP bounce under sharding (their lane
    shuffles must commute with the mesh partition)."""
    import jax.numpy as jnp
    from ptx.core import rng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays
    from ptx.parallel.render import make_train_step

    tiles, samples = 4, 2
    m = pmesh.make_mesh(tiles=tiles, samples=samples)
    key = jax.random.PRNGKey(5)
    depth, spp = 8, 2 * samples
    rows = CAM.height // tiles
    target = np.zeros((CAM.height, CAM.width, 3), np.float32)

    step = make_train_step(scene, CAM, m, spp=spp, depth=depth,
                           learning_rate=0.0,  # pure gradient probe
                           compact=True, manual_vjp=True)
    # learning_rate 0 ⇒ params unchanged; grab loss via a 1-step psum'd
    # run, and gradients by finite re-derivation: rebuild the same global
    # loss unsharded and compare value_and_grad
    _, loss_sharded = step(scene.params, jnp.asarray(target),
                           jax.random.fold_in(key, 1))

    def unsharded_loss(params):
        k0 = jax.random.fold_in(key, 1)
        total = 0.0
        for t in range(tiles):
            # _local_render pmeans the image over the SAMPLE axis BEFORE
            # the (nonlinear) MSE — mirror that exactly
            img = 0.0
            for s in range(samples):
                k = rng.fold(k0, t, s)
                ys = t * rows + jnp.arange(rows)
                o, d = sample_rays(CAM, k, ys, jnp.arange(CAM.width),
                                   spp // samples)
                rad = trace_rays(scene, params, o, d, k, depth,
                                 compact=True, manual_vjp=True)
                img = img + jnp.mean(rad, axis=0) / samples
            total = total + jnp.mean(
                (img - target[t * rows:(t + 1) * rows]) ** 2)
        return total / tiles

    loss_u, grads_u = jax.jit(jax.value_and_grad(unsharded_loss))(
        scene.params)
    np.testing.assert_allclose(float(loss_sharded), float(loss_u),
                               rtol=1e-5)

    # gradients: recompute the sharded ones via a grad-returning step
    from ptx.parallel.render import _local_render
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ptx.parallel.mesh import SAMPLE_AXIS, TILE_AXIS

    def body(params, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        y0 = tile_idx * rows

        def local_loss(p):
            img = _local_render(scene, CAM, depth, spp // samples, p, key,
                                y0, rows, compact=True, manual_vjp=True)
            return jnp.mean(
                (img - jax.lax.dynamic_slice(
                    jnp.asarray(target), (y0, 0, 0),
                    (rows, CAM.width, 3))) ** 2)

        g = jax.grad(local_loss)(params)
        return jax.lax.pmean(jax.lax.pmean(g, TILE_AXIS), SAMPLE_AXIS)

    grads_s = jax.jit(shard_map(
        body, mesh=m, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))(scene.params, jax.random.fold_in(key, 1))

    flat_u = jax.tree_util.tree_flatten_with_path(grads_u)[0]
    flat_s = jax.tree_util.tree_flatten_with_path(grads_s)[0]
    for (pu, vu), (ps, vs) in zip(flat_u, flat_s):
        assert pu == ps
        np.testing.assert_allclose(np.asarray(vs), np.asarray(vu),
                                   rtol=2e-4, atol=1e-7,
                                   err_msg=str(pu))


def test_mega_shaped_scene_sharded():
    """The large-scene production semantics under shard_map: the
    fixpoint union sweep on a COMPOSED scene (stress spheres under the
    equirect image sky), sharded-vs-unsharded loss AND grads pinned,
    compaction + manual VJP on."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ptx.core import rng
    from ptx.geom.fasthit import compile_fast_hit
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays
    from ptx.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
    from ptx.parallel.render import make_train_step
    from ptx.scenes.builders import procedural_sky_image, stress_spheres

    img = procedural_sky_image(24, 48)
    scene = compile_scene(stress_spheres(16, sky_image=img))
    scene.hit_fn = compile_fast_hit(scene.plan, sweep=True)
    scene._manual_bounce = None

    tiles, samples = 4, 2
    m = pmesh.make_mesh(tiles=tiles, samples=samples)
    key = jax.random.PRNGKey(13)
    depth, spp = 8, 2 * samples
    rows = CAM.height // tiles
    target = np.zeros((CAM.height, CAM.width, 3), np.float32)

    step = make_train_step(scene, CAM, m, spp=spp, depth=depth,
                           learning_rate=0.0, compact=True,
                           manual_vjp=True)
    _, loss_sharded = step(scene.params, jnp.asarray(target),
                           jax.random.fold_in(key, 1))

    def unsharded_loss(params):
        k0 = jax.random.fold_in(key, 1)
        total = 0.0
        for t in range(tiles):
            img_acc = 0.0
            for s in range(samples):
                k = rng.fold(k0, t, s)
                ys = t * rows + jnp.arange(rows)
                o, d = sample_rays(CAM, k, ys, jnp.arange(CAM.width),
                                   spp // samples)
                rad = trace_rays(scene, params, o, d, k, depth,
                                 compact=True, manual_vjp=True)
                img_acc = img_acc + jnp.mean(rad, axis=0) / samples
            total = total + jnp.mean(
                (img_acc - target[t * rows:(t + 1) * rows]) ** 2)
        return total / tiles

    loss_u, grads_u = jax.jit(jax.value_and_grad(unsharded_loss))(
        scene.params)
    np.testing.assert_allclose(float(loss_sharded), float(loss_u),
                               rtol=1e-5)

    def body(params, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        y0 = tile_idx * rows

        def local_loss(p):
            from ptx.parallel.render import _local_render
            img_l = _local_render(scene, CAM, depth, spp // samples, p,
                                  key, y0, rows, compact=True,
                                  manual_vjp=True)
            return jnp.mean(
                (img_l - jax.lax.dynamic_slice(
                    jnp.asarray(target), (y0, 0, 0),
                    (rows, CAM.width, 3))) ** 2)

        g = jax.grad(local_loss)(params)
        return jax.lax.pmean(jax.lax.pmean(g, TILE_AXIS), SAMPLE_AXIS)

    grads_s = jax.jit(shard_map(
        body, mesh=m, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))(scene.params, jax.random.fold_in(key, 1))

    img_u = np.asarray(jax.tree.leaves(grads_u["images"])[0])
    img_s = np.asarray(jax.tree.leaves(grads_s["images"])[0])
    assert np.abs(img_u).max() > 0, "unsharded sky-image cotangent is zero"
    np.testing.assert_allclose(img_s, img_u, rtol=2e-4, atol=1e-7,
                               err_msg="sky-image cotangent")

    flat_u = jax.tree_util.tree_flatten_with_path(grads_u)[0]
    flat_s = jax.tree_util.tree_flatten_with_path(grads_s)[0]
    for (pu, vu), (ps, vs) in zip(flat_u, flat_s):
        assert pu == ps
        np.testing.assert_allclose(np.asarray(vs), np.asarray(vu),
                                   rtol=2e-4, atol=1e-7,
                                   err_msg=str(pu))


def test_flagship_image_stack_sharded():
    """The FLAGSHIP stack — image equirect sky, sky-select post-scan
    emission, the image gather and its scatter-add transpose — must produce the
    same loss and the same parameter gradients (INCLUDING the sky-image
    cotangent) inside shard_map as an unsharded replay with
    ``compact=True, manual_vjp=True``.  The const-sky digest test above
    never executes these paths; a lane-indexing bug in the sky-select
    one-hot or the texture-eval gather under a mesh partition would pass
    it and the whole CPU suite."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ptx.core import rng
    from ptx.integrate.camera import sample_rays
    from ptx.integrate.trace import trace_rays
    from ptx.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
    from ptx.parallel.render import _local_render, make_train_step
    from ptx.scenes.builders import make_world

    scene = compile_scene(make_world())
    assert scene.params["images"], "flagship scene must carry an image sky"

    tiles, samples = 4, 2
    m = pmesh.make_mesh(tiles=tiles, samples=samples)
    key = jax.random.PRNGKey(7)
    depth, spp = 8, 2 * samples
    rows = CAM.height // tiles
    target = np.zeros((CAM.height, CAM.width, 3), np.float32)

    step = make_train_step(scene, CAM, m, spp=spp, depth=depth,
                           learning_rate=0.0, compact=True,
                           manual_vjp=True)
    _, loss_sharded = step(scene.params, jnp.asarray(target),
                           jax.random.fold_in(key, 1))

    def unsharded_loss(params):
        k0 = jax.random.fold_in(key, 1)
        total = 0.0
        for t in range(tiles):
            img = 0.0
            for s in range(samples):
                k = rng.fold(k0, t, s)
                ys = t * rows + jnp.arange(rows)
                o, d = sample_rays(CAM, k, ys, jnp.arange(CAM.width),
                                   spp // samples)
                rad = trace_rays(scene, params, o, d, k, depth,
                                 compact=True, manual_vjp=True)
                img = img + jnp.mean(rad, axis=0) / samples
            total = total + jnp.mean(
                (img - target[t * rows:(t + 1) * rows]) ** 2)
        return total / tiles

    loss_u, grads_u = jax.jit(jax.value_and_grad(unsharded_loss))(
        scene.params)
    np.testing.assert_allclose(float(loss_sharded), float(loss_u),
                               rtol=1e-5)

    def body(params, key):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        y0 = tile_idx * rows

        def local_loss(p):
            img = _local_render(scene, CAM, depth, spp // samples, p, key,
                                y0, rows, compact=True, manual_vjp=True)
            return jnp.mean(
                (img - jax.lax.dynamic_slice(
                    jnp.asarray(target), (y0, 0, 0),
                    (rows, CAM.width, 3))) ** 2)

        g = jax.grad(local_loss)(params)
        return jax.lax.pmean(jax.lax.pmean(g, TILE_AXIS), SAMPLE_AXIS)

    grads_s = jax.jit(shard_map(
        body, mesh=m, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))(scene.params, jax.random.fold_in(key, 1))

    # the sky-image cotangent must be present, nonzero, and equal
    img_u = np.asarray(jax.tree.leaves(grads_u["images"])[0])
    img_s = np.asarray(jax.tree.leaves(grads_s["images"])[0])
    assert np.abs(img_u).max() > 0, "unsharded sky-image cotangent is zero"
    np.testing.assert_allclose(img_s, img_u, rtol=2e-4, atol=1e-7,
                               err_msg="sky-image cotangent")

    flat_u = jax.tree_util.tree_flatten_with_path(grads_u)[0]
    flat_s = jax.tree_util.tree_flatten_with_path(grads_s)[0]
    for (pu, vu), (ps, vs) in zip(flat_u, flat_s):
        assert pu == ps
        np.testing.assert_allclose(np.asarray(vs), np.asarray(vu),
                                   rtol=2e-4, atol=1e-7,
                                   err_msg=str(pu))


def test_render_accumulator_resume(tmp_path):
    p = str(tmp_path / "acc.npz")
    acc = checkpoint.RenderAccumulator(4, 4, p)
    img1 = np.full((4, 4, 3), 2.0, np.float32)
    img2 = np.full((4, 4, 3), 4.0, np.float32)
    acc.add(img1, spp=2)
    acc.save()
    acc2 = checkpoint.RenderAccumulator(4, 4, p)     # resume from disk
    assert acc2.samples_done == 2
    acc2.add(img2, spp=2)
    np.testing.assert_allclose(acc2.image(), 3.0)


def test_params_checkpoint_roundtrip(tmp_path, scene):
    p = str(tmp_path / "params.npz")
    key = jax.random.PRNGKey(3)
    checkpoint.save_params(p, scene.params, step=7, key=key)
    params, step, key2 = checkpoint.load_params(p, scene.params)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(key), np.asarray(key2))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), scene.params, params)


def test_adaptive_checkpoint_resume(tmp_path, scene):
    """Interrupt the adaptive render after round 1, resume from the
    checkpoint, and get EXACTLY the uninterrupted result (the refinement
    sequence is deterministic in (state, key))."""
    import jax.numpy as jnp
    from ptx.integrate.adaptive import render_adaptive
    from ptx.parallel.checkpoint import AdaptiveCheckpoint

    key = jax.random.PRNGKey(11)
    kw = dict(spp_base=2, rounds=3, frac=0.25, spp_refine=2, depth=3)

    img_full, counts_full, _ = render_adaptive(scene, CAM, key, **kw)

    p = str(tmp_path / "adaptive.npz")
    ck = AdaptiveCheckpoint(CAM.height, CAM.width, p)
    # run only base + 1 round, checkpointing each step
    render_adaptive(scene, CAM, key, **{**kw, "rounds": 1},
                    state=ck.state, on_round=ck.update)
    assert ck.rounds_done == 1
    # resume in a fresh process-equivalent: reload from disk
    ck2 = AdaptiveCheckpoint(CAM.height, CAM.width, p)
    assert ck2.rounds_done == 1
    img_res, counts_res, _ = render_adaptive(scene, CAM, key, **kw,
                                             state=ck2.state,
                                             on_round=ck2.update)
    np.testing.assert_array_equal(np.asarray(counts_res),
                                  np.asarray(counts_full))
    np.testing.assert_allclose(np.asarray(img_res), np.asarray(img_full),
                               rtol=1e-6, atol=1e-7)


def test_adaptive_sharded_base_pass(scene):
    """The adaptive base pass runs under shard_map; moments must equal
    the mesh-shape-independent totals (same per-(tile, sample) folds)."""
    from ptx.integrate.adaptive import render_adaptive

    m = pmesh.make_mesh(tiles=4, samples=2)
    key = jax.random.PRNGKey(12)
    img, counts, _ = render_adaptive(scene, CAM, key, spp_base=2,
                                     rounds=2, frac=0.25, spp_refine=2,
                                     depth=3, mesh=m)
    assert np.isfinite(np.asarray(img)).all()
    assert np.asarray(counts).min() >= 2
    assert np.asarray(counts).max() > 2      # refinement concentrated
