"""Native C++ runtime (OBJ parser, SAH BVH builder) vs the numpy oracles."""
import os
import numpy as np
import jax.numpy as jnp
import pytest

from jet_pbrt_tpu.utils.native import (
    native_available, try_load_obj_native, try_build_bvh_native,
)
from jet_pbrt_tpu.scene import objio
from jet_pbrt_tpu.ops import bvh as bvh_ops


@pytest.fixture()
def native_lib():
    """The native library, built at first use; skips if it cannot be
    built on this machine (decided when the test runs)."""
    if not native_available():
        pytest.skip("native library could not be built (make -C native)")


OBJ_SAMPLE = """\
# sample
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f -4 -3 -2
"""


@pytest.fixture()
def obj_path(tmp_path):
    p = tmp_path / "sample.obj"
    p.write_text(OBJ_SAMPLE)
    return str(p)


def test_native_obj_matches_python(native_lib, obj_path):
    tris_n, uvs_n = try_load_obj_native(obj_path)
    # force the python parser by parsing the text path directly
    import jet_pbrt_tpu.utils.native as native_mod

    orig = native_mod.try_load_obj_native
    native_mod.try_load_obj_native = lambda _: None
    try:
        tris_p, uvs_p = objio.load_obj(obj_path)
    finally:
        native_mod.try_load_obj_native = orig
    assert tris_n.shape == tris_p.shape == (3, 3, 3)  # quad fan -> 2 + 1 tris
    np.testing.assert_allclose(tris_n, tris_p)
    np.testing.assert_allclose(uvs_n, uvs_p)


def test_native_bvh_valid_and_traversable(native_lib):
    rng = np.random.default_rng(0)
    t = 500
    base = rng.uniform(-10, 10, (t, 1, 3)).astype(np.float32)
    tris = base + rng.uniform(-0.5, 0.5, (t, 3, 3)).astype(np.float32)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]

    (bmin, bmax, miss, first, count), order = try_build_bvh_native(
        p0, p1, p2, bvh_ops.LEAF_SIZE, use_sah=True
    )
    n = len(bmin)
    # structural invariants
    assert np.all((miss > 0) & (miss <= n) | (miss == n))
    leaves = first >= 0
    assert count[leaves].max() <= bvh_ops.LEAF_SIZE
    assert count[leaves].min() >= 1
    # every real triangle appears in some leaf
    assert set(np.unique(order)) == set(range(t))
    # order length is leaf_count-padded
    assert len(order) == leaves.sum() * bvh_ops.LEAF_SIZE

    # traversal equivalence vs brute force through the pack machinery
    from jet_pbrt_tpu.scene.builder import SceneBuilder

    b = SceneBuilder("nat")
    b.set_camera(lookfrom=(0, 0, 40), lookat=(0, 0, 0))
    m = b.add_matte((0.5, 0.5, 0.5))
    b.add_mesh(tris, m)
    s_sah = b.build(use_bvh=True)

    b2 = SceneBuilder("nat2")
    b2.set_camera(lookfrom=(0, 0, 40), lookat=(0, 0, 0))
    m2 = b2.add_matte((0.5, 0.5, 0.5))
    b2.add_mesh(tris, m2)
    s_brute = b2.build(use_bvh=False)

    import jax
    from jet_pbrt_tpu.scene import pack as SP

    nrays = 2048
    o = jnp.zeros((nrays, 3)) + jnp.asarray([0.0, 0.0, 40.0])
    d = jax.random.normal(jax.random.key(1), (nrays, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    tmin = jnp.full((nrays,), 1e-3)
    tmax = jnp.full((nrays,), jnp.inf)
    h_a = SP.intersect(s_sah.meta, s_sah.pack, o, d, tmin, tmax)
    h_b = SP.intersect(s_brute.meta, s_brute.pack, o, d, tmin, tmax)
    assert np.array_equal(np.asarray(h_a.valid), np.asarray(h_b.valid))
    ok = np.asarray(h_a.valid)
    np.testing.assert_allclose(
        np.asarray(h_a.t)[ok], np.asarray(h_b.t)[ok], rtol=1e-5, atol=1e-4
    )


def test_native_bvh_bunny_scale(native_lib):
    """SAH build of the ~70k-tri bunny completes fast and traverses."""
    from jet_pbrt_tpu.scene.assets import bunny_mesh

    tris = bunny_mesh(20000)
    p0, p1, p2 = tris[:, 0], tris[:, 1], tris[:, 2]
    import time

    t0 = time.perf_counter()
    out = try_build_bvh_native(p0, p1, p2, bvh_ops.LEAF_SIZE, use_sah=True)
    dt = time.perf_counter() - t0
    assert out is not None
    (bmin, _, _, first, _), order = out
    assert dt < 5.0
    assert set(np.unique(order)) == set(range(len(tris)))
