"""Differentiable-rendering tests: autodiff pixel gradients match finite
differences for albedo and emission; gradient descent recovers parameters
(BASELINE.json north-star gradient requirements)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from jet_pbrt_tpu.scene.builder import SceneBuilder
from jet_pbrt_tpu.scene.scenes import cornell_box
from jet_pbrt_tpu.models.render import render_fn
from jet_pbrt_tpu.diff import params as P
from jet_pbrt_tpu.diff.gradcheck import check_grads


def tiny_scene():
    """Matte floor + area light: smooth in albedo and emission for
    max_depth<=2 (no RR, no stochastic lobe picks)."""
    b = SceneBuilder("grad")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    m = b.add_matte((0.5, 0.4, 0.3))
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


def scalar_render(scene, fields, spp=8, size=8, max_depth=2):
    fn, pack = render_fn(scene, size, size, spp, seed=0, max_depth=max_depth)

    def f(params):
        return jnp.mean(fn(P.with_params(pack, params)))

    return f, P.get_params(pack, fields)


@pytest.mark.slow
def test_albedo_gradient_allclose_fd():
    scene = tiny_scene()
    f, params = scalar_render(scene, ("mat_c0",))
    check_grads(f, params, rtol=5e-2, eps=1e-3)


@pytest.mark.slow
def test_emission_gradient_allclose_fd():
    scene = tiny_scene()
    f, params = scalar_render(scene, ("light_c",))
    # emission enters linearly -> gradients should match tightly
    check_grads(f, params, rtol=2e-2, eps=1e-2)


def test_emission_gradient_is_linear():
    """L is linear in light_c, so grad wrt emission is exactly the
    renders-per-unit-emission image mean."""
    scene = tiny_scene()
    f, params = scalar_render(scene, ("light_c",), spp=4)
    g = jax.grad(f)(params)["light_c"]
    base = float(f({**params, "light_c": jnp.zeros_like(params["light_c"])}))
    one = {**params, "light_c": jnp.ones_like(params["light_c"])}
    lin = float(f(one)) - base
    assert abs(float(g.sum()) - lin) / max(lin, 1e-9) < 1e-3


def metal_scene(roughness=0.25):
    """GGX metal floor under an area light. With max_depth=1 and no MIS the
    BSDF-sampled continuation contributes NO radiance (non-delta hits on
    lights are not credited, reference: src/integrator.cc:328-337), so the
    image depends on roughness only through the NEE *eval* of the GGX lobe
    — fully pathwise-differentiable: FD and autodiff must agree."""
    b = SceneBuilder("grad-rough")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    m = b.add_metal((0.2, 0.92, 1.1), (3.9, 2.45, 2.14), roughness,
                    roughness, remap=False)
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


def textured_scene():
    """Matte floor whose Kd is a 2x2 bilinear image texture: texel values
    enter the estimator linearly (albedo-like), so FD == autodiff."""
    b = SceneBuilder("grad-tex")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0, 0), vfov=45)
    tex = b.add_image_texture(
        np.asarray([[[0.7, 0.3, 0.2], [0.3, 0.7, 0.2]],
                    [[0.2, 0.3, 0.7], [0.5, 0.5, 0.5]]], np.float32),
        bilinear=True,
    )
    m = b.add_matte((1.0, 1.0, 1.0), tex=tex)
    b.add_rect_xz(-10, 10, -10, 10, 0, m)
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build(use_bvh=False)


@pytest.mark.slow
def test_roughness_gradient_allclose_fd():
    """BASELINE config #4: roughness gradients FD-verified through the GGX
    D/Lambda terms (src/microfacet.cc math on the autodiff tape)."""
    scene = metal_scene()
    f, params = scalar_render(scene, ("mat_s0",), spp=8, size=8, max_depth=1)
    g = check_grads(f, params, rtol=5e-2, eps=1e-3)[0]
    # the metal row's roughness must actually matter
    assert abs(float(g["mat_s0"][0])) > 1e-4


@pytest.mark.slow
def test_texel_gradient_allclose_fd():
    """BASELINE config #4: per-texel gradients FD-verified through the
    bilinear texture taps (the capability the reference's dead texture
    subsystem never delivers, SURVEY.md §2 #36)."""
    scene = textured_scene()
    f, params = scalar_render(scene, ("tex_image",), spp=4, size=6,
                              max_depth=1)
    g = check_grads(f, params, rtol=5e-2, eps=1e-3)[0]
    assert float(jnp.abs(g["tex_image"]).sum()) > 1e-4


@pytest.mark.slow
def test_gradient_descent_recovers_roughness():
    """Inverse rendering recovers a scalar roughness (BASELINE config #4
    'roughness grads' end-to-end)."""
    scene = metal_scene(roughness=0.2)
    fn, pack = render_fn(scene, 8, 8, 8, seed=0, max_depth=1)
    target = fn(pack)
    wrong = pack.mat_s0.at[0].set(0.45)
    params, losses = P.fit(fn, pack._replace(mat_s0=wrong), target,
                           fields=("mat_s0",), steps=80, lr=2.0)
    assert losses[-1] < losses[0] * 0.05
    assert abs(float(params["mat_s0"][0]) - 0.2) < 0.04


@pytest.mark.slow
def test_gradient_descent_recovers_albedo():
    scene = tiny_scene()
    size, spp = 8, 8
    fn, pack = render_fn(scene, size, size, spp, seed=0, max_depth=2)
    target_img = fn(pack)  # ground-truth albedo (0.5, 0.4, 0.3)

    # start from a wrong albedo, keep emission fixed
    wrong = pack.mat_c0.at[0].set(jnp.asarray([0.9, 0.1, 0.7]))
    pack_wrong = pack._replace(mat_c0=wrong)
    params, losses = P.fit(fn, pack_wrong, target_img, fields=("mat_c0",),
                           steps=120, lr=4.0)
    assert losses[-1] < losses[0] * 2e-2
    got = np.asarray(params["mat_c0"][0])
    assert np.allclose(got, [0.5, 0.4, 0.3], atol=0.05)


@pytest.mark.slow
def test_cornell_grad_flows():
    """Smoke: gradients exist and are finite on the full cornell scene
    (metal+RR paths included; detached sampling keeps them finite)."""
    scene = cornell_box(lambert_only=False, use_bvh=False)
    fn, pack = render_fn(scene, 8, 8, 4, seed=0, max_depth=5)

    def f(params):
        return jnp.mean(fn(P.with_params(pack, params)))

    g = jax.grad(f)(P.get_params(pack))
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), k
    # albedo of the white walls must matter
    assert float(jnp.abs(g["mat_c0"]).sum()) > 0
    assert float(jnp.abs(g["light_c"]).sum()) > 0


def instanced_scene():
    """Two matte instances of one BLAS (so every triangle hit takes the
    skip-link walk) over a matte floor, lit by an area light."""
    rng = np.random.default_rng(2)
    v0 = rng.uniform(-0.6, 0.6, (60, 3)).astype(np.float32)
    tris = np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (60, 3)),
                     v0 + rng.uniform(-0.3, 0.3, (60, 3))], axis=1)
    b = SceneBuilder("grad-inst")
    b.set_camera(lookfrom=(0, 2, 5), lookat=(0, 0.5, 0), vfov=45)
    floor = b.add_matte((0.5, 0.4, 0.3))
    b.add_rect_xz(-10, 10, -10, 10, 0, floor)
    m0 = b.add_matte((0.7, 0.2, 0.2))
    m1 = b.add_matte((0.2, 0.6, 0.3))
    b.add_instanced_mesh(tris, [((-0.8, 0.7, 0), 1.0, m0),
                                ((0.8, 0.7, 0), 0.8, m1)])
    lm = b.add_matte((0.6, 0.6, 0.6))
    r = b.add_rect_xz(-1, 1, -1, 1, 3, lm, flip_normal=True)
    b.add_area_light(r, (3.0, 3.0, 3.0))
    return b.build()


def test_instanced_walk_albedo_gradient_allclose_fd():
    """Albedo gradients through a walk-routed, instanced scene match
    central differences (same method and tolerance as the albedo test
    above). The walk's lax.while_loop carries no parameter, so reverse mode
    differentiates around it."""
    scene = instanced_scene()
    assert scene.meta.n_inst == (2,)
    f, params = scalar_render(scene, ("mat_c0",), spp=4)
    g = check_grads(jax.jit(f), params, rtol=5e-2, eps=1e-3)[0]
    # both instance materials are seen by the camera
    assert np.all(np.abs(np.asarray(g["mat_c0"])[1:3]) > 1e-4)
