"""Table lookups on the main path are exact.

Material, emission and instance rows are fetched by plain indexing, so they
come back bitwise equal to numpy indexing. A float32 matrix product would
not: on a GPU it may run in TF32, which keeps 10 mantissa bits. The table
values here need all 23, and no matrix product may appear in the wave."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jet_pbrt_tpu.models import camera as camera_mod
from jet_pbrt_tpu.models.render import _wave_fn
from jet_pbrt_tpu.scene import pack as scene_pack
from jet_pbrt_tpu.scene.builder import SceneBuilder
from jet_pbrt_tpu.scene.scenes import bunny_scene, cornell_box

N = 1 << 16


def _full_mantissa(rng, shape, lo=0.05, hi=2.0):
    """float32 values whose low 13 mantissa bits are not all zero, so TF32
    rounding would change every one of them."""
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    bits = x.view(np.uint32) | np.uint32(1)
    return bits.view(np.float32)


def _exact(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _lookup_case(table: str, rng):
    """(device fn of an index vector, numpy reference, index vector)."""
    b = SceneBuilder(f"lookup_{table}")
    b.set_camera(lookfrom=(0, 0, 8), lookat=(0, 0, 0))
    if table == "materials":
        for i in range(37):
            c0, c1 = _full_mantissa(rng, (2, 3), hi=1.0)
            r = float(_full_mantissa(rng, (), hi=0.9))
            if i % 3 == 0:
                b.add_matte(c0)
            elif i % 3 == 1:
                b.add_metal(c0, c1, r, r / 2)
            else:
                b.add_plastic(c0, c1, r)
        pack = b.build().pack
        idx = rng.integers(0, 37, N).astype(np.int32)

        def fn(i):
            return scene_pack.gather_material(pack, i)

        ref = tuple(np.asarray(getattr(pack, f))[idx] for f in (
            "mat_kind", "mat_c0", "mat_c1", "mat_s0", "mat_s1", "mat_remap",
            "mat_tex", "mat_mf"))
        return fn, ref, idx
    if table == "emission":
        m = b.add_matte((0.5, 0.5, 0.5))
        for _ in range(29):
            r = b.add_rect_xz(-1, 1, -1, 1, 2, m, flip_normal=True)
            b.add_area_light(r, _full_mantissa(rng, 3, hi=20.0))
        pack = b.build().pack
        light_c = np.asarray(pack.light_c)
        idx = rng.integers(-1, len(light_c), N).astype(np.int32)

        def fn(i):
            up = jnp.broadcast_to(jnp.float32([0, 1, 0]), (N, 3))
            hit = scene_pack.Hit(
                valid=jnp.ones((N,), bool), t=jnp.ones((N,)),
                position=jnp.zeros((N, 3)), normal=up, wo=up,
                uv=jnp.zeros((N, 2)), mat_id=jnp.zeros((N,), jnp.int32),
                light_id=i)
            return scene_pack.emitted(pack, hit)

        ref = np.where((idx >= 0)[:, None], light_c[np.maximum(idx, 0)],
                       np.float32(0))
        return fn, ref, idx
    mats = [b.add_matte(c) for c in _full_mantissa(rng, (5, 3), hi=1.0)]
    tri = np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    offs = _full_mantissa(rng, (23, 3), lo=-40.0, hi=40.0)
    scales = _full_mantissa(rng, 23, lo=0.1, hi=3.0)
    b.add_instanced_mesh(tri, [(o, s, mats[i % 5])
                               for i, (o, s) in enumerate(zip(offs, scales))])
    pack = b.build().pack
    idx = rng.integers(0, 23, N).astype(np.int32)

    def fn(i):
        return scene_pack.instance_rows(pack, 0, i)

    ref = tuple(np.asarray(getattr(pack, f)[0])[idx] for f in (
        "inst_off", "inst_scale", "inst_mat", "inst_light"))
    return fn, ref, idx


@pytest.mark.parametrize("table", ["materials", "emission", "instances"])
def test_lookup_bitwise_exact(table):
    fn, ref, idx = _lookup_case(table, np.random.default_rng(4))
    out = jax.jit(fn)(jnp.asarray(idx))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        _exact(a, b)


def _wave(scene, width=8, spp=None, seed=0):
    """The jitted path-tracing wave of models/render.py and its args."""
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, width))
    wave = _wave_fn(scene.meta, width, width, 5, "path", False, spp=spp,
                    seed=seed)
    ids = jnp.arange(width * width, dtype=jnp.int32)
    return wave, (scene.pack, cam, ids, jnp.int32(0))


SCENES = {"cornell": lambda: cornell_box(lambert_only=False, use_bvh=False),
          "bunny": bunny_scene}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_wave_has_no_matmul(name):
    """No dot/dot_general in the lowered wave of either benchmark scene."""
    x = jnp.ones((4, 4))
    assert "dot_general" in jax.jit(lambda a: a @ a).lower(x).as_text()
    wave, args = _wave(SCENES[name]())
    text = wave.lower(*args).as_text()
    assert not re.search(r"dot_general|stablehlo\.dot\b", text)


# (width, spp, seed) of the converged-golden renders in tests/test_golden.py:
# compiling the very same wave lets the persistent compile cache serve the
# golden test's compile when both run in one process (chip_smoke.py)
GOLDEN_WAVES = {"cornell": (48, 512, 7), "bunny": (64, 32, 9)}


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(SCENES))
def test_wave_compiles_without_gemm_on_gpu(name):
    """XLA's GPU compiler introduces no matrix product (a dot, or a cuBLAS
    or Triton gemm, which may run in TF32) into the optimized wave."""
    width, spp, seed = GOLDEN_WAVES[name]
    wave, args = _wave(SCENES[name](), width, spp, seed)
    text = wave.lower(*args).compile().as_text()
    m = re.search(r'\bdot\(|custom_call_target="__cublas|"__triton_gemm"',
                  text)
    assert not m, text[max(m.start() - 300, 0):m.end() + 100]
