"""Sharded-rendering tests on the 8-virtual-device CPU mesh: sharded film
matches single-device render, spp-axis psum correctness, distributed
gradient fit."""
import numpy as np
import jax
import jax.numpy as jnp

from jet_pbrt_tpu.scene.scenes import cornell_box
from jet_pbrt_tpu.parallel.mesh import make_mesh
from jet_pbrt_tpu.parallel.render import render_sharded, build_sharded_render
from jet_pbrt_tpu.parallel.train import build_train_step
from jet_pbrt_tpu.models import camera as camera_mod
from jet_pbrt_tpu.diff import params as P


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape == {"px": 8, "spp": 1}
    m2 = make_mesh(px=4, spp=2)
    assert m2.shape == {"px": 4, "spp": 2}


def test_sharded_layout_invariant():
    """RNG streams are keyed by global (pixel, sample) ids, never the shard
    layout: every mesh shape renders the SAME image. px-only relayouts are
    bitwise; spp relayouts reassociate the per-pixel psum, so tolerance."""
    s = cornell_box(lambert_only=True, use_bvh=False)
    img_a = render_sharded(s, 16, 16, 8, make_mesh(px=8, spp=1), seed=5,
                           clamp=False)
    img_b = render_sharded(s, 16, 16, 8, make_mesh(px=4, spp=1,
                                                   devices=jax.devices()[:4]),
                           seed=5, clamp=False)
    img_c = render_sharded(s, 16, 16, 8, make_mesh(px=4, spp=2), seed=5,
                           clamp=False)
    img_d = render_sharded(s, 16, 16, 8, make_mesh(px=2, spp=4), seed=5,
                           clamp=False)
    np.testing.assert_array_equal(img_a, img_b)
    np.testing.assert_allclose(img_c, img_a, atol=2e-4)
    np.testing.assert_allclose(img_d, img_a, atol=2e-4)


def test_sharded_matches_single_chip():
    """The sharded renderer computes the same estimator with the same
    streams as the single-chip renderer (difference: f64 vs f32 film
    accumulation only)."""
    from jet_pbrt_tpu.models.render import render

    s = cornell_box(lambert_only=True, use_bvh=False)
    img_s = render(s, 16, 16, spp=8, seed=5, clamp=False)
    img_m = render_sharded(s, 16, 16, 8, make_mesh(px=4, spp=2), seed=5,
                           clamp=False)
    np.testing.assert_allclose(img_m, img_s, atol=5e-3, rtol=1e-3)


def test_sharded_walk_scene_matches_single_chip():
    """An instanced scene, whose triangles take the BVH walk (a nested
    lax.while_loop), renders through shard_map like the single-chip
    renderer."""
    from jet_pbrt_tpu.models.render import render
    from jet_pbrt_tpu.scene.builder import SceneBuilder

    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (80, 3)).astype(np.float32)
    tris = np.stack([v0, v0 + rng.uniform(-0.4, 0.4, (80, 3)),
                     v0 + rng.uniform(-0.4, 0.4, (80, 3))], axis=1)
    b = SceneBuilder("sharded-walk")
    b.set_camera(lookfrom=(0, 0, 6), lookat=(0, 0, 0), vfov=50)
    b.add_env_light((0.3, 0.4, 0.5))
    m = b.add_matte((0.7, 0.5, 0.3))
    b.add_instanced_mesh(tris, [((-1, 0, 0), 1.0, m), ((1.2, 0.3, 0), 0.7, m)])
    s = b.build()
    img_s = render(s, 16, 16, spp=4, seed=3, max_depth=3, clamp=False)
    img_m = render_sharded(s, 16, 16, 4, make_mesh(px=4, spp=2), seed=3,
                           max_depth=3, clamp=False)
    assert img_s.mean() > 0.05
    np.testing.assert_allclose(img_m, img_s, atol=5e-3, rtol=1e-3)


def test_sharded_sampler_parity():
    """stratified/debug samplers work identically through the sharded path
    (single-chip API parity; reference stubs both, src/sampler.h:109-185)."""
    from jet_pbrt_tpu.models.render import render

    s = cornell_box(lambert_only=True, use_bvh=False)
    for sampler in ("stratified", "debug"):
        img_s = render(s, 8, 8, spp=4, seed=3, clamp=False, sampler=sampler)
        img_m = render_sharded(s, 8, 8, 4, make_mesh(px=4, spp=2), seed=3,
                               clamp=False, sampler=sampler)
        np.testing.assert_allclose(img_m, img_s, atol=5e-3, rtol=1e-3)


def test_sharded_grad_fit():
    """Distributed albedo fit on the 8-device mesh drives loss down."""
    s = cornell_box(lambert_only=True, use_bvh=False)
    mesh = make_mesh(px=4, spp=2)
    step, init, render, cam = build_train_step(
        s, mesh, 16, 16, 4, fields=("mat_c0",), lr=2.0, max_depth=2
    )
    target = render(s.pack, cam)
    # perturb the white-wall albedo
    wrong = s.pack.mat_c0.at[2].set(jnp.asarray([0.2, 0.9, 0.2]))
    params = {"mat_c0": wrong}
    losses = []
    for _ in range(25):
        params, loss = step(params, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1
    got = np.asarray(params["mat_c0"][2])
    assert np.allclose(got, [0.725, 0.71, 0.68], atol=0.1)
