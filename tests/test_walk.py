"""The skip-link BVH walk (ops/bvh.py), the only traversal route, against
brute force over every world-space triangle: closest hit and any hit, for a
triangle soup and for instanced copies of one BLAS, at leaf sizes 1 and 4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jet_pbrt_tpu.scene.builder import SceneBuilder
from jet_pbrt_tpu.scene import pack as scene_pack

from walk_reference import brute_force, world_triangles

N_RAYS = 2048
# Walk and brute force evaluate Moller-Trumbore from differently rounded
# inputs (stored edges vs p1 - p0; instance-local vs world space), so rays
# grazing an edge may flip. Allow a few such rays, and float32 rounding of
# t through the instance transform.
MAX_FLIPS = 0.002
T_RTOL = 1e-4


def _mesh(t=300, seed=3):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (t, 3)),
                     v0 + rng.uniform(-0.3, 0.3, (t, 3))], axis=1)


def _scene(layout: str, leaf: int):
    b = SceneBuilder(f"walk_{layout}_{leaf}")
    b.set_camera(lookfrom=(0, 0, 8), lookat=(0, 0, 0))
    m = b.add_matte((0.5, 0.5, 0.5))
    if layout == "soup":
        b.add_mesh(_mesh(), m)
        return b.build(use_bvh=True, bvh_leaf_size=leaf)
    b.add_instanced_mesh(_mesh(), [((0, 0, 0), 1.0, m),
                                   ((1.7, 0.4, -0.5), 0.6, m),
                                   ((-1.2, -1.5, 0.8), 1.3, m)])
    return b.build(bvh_leaf_size=leaf)


def _rays(seed=7):
    """Origins on a sphere around the meshes, aimed at random points among
    them: most rays hit, some graze, some miss."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(N_RAYS, 3))
    o = 6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("leaf", [1, 4])
@pytest.mark.parametrize("layout", ["soup", "instanced"])
@pytest.mark.parametrize("query", ["closest", "any"])
def test_walk_matches_brute_force(query, layout, leaf):
    scene = _scene(layout, leaf)
    assert scene.meta.bvh_leaf_size == leaf
    assert scene.meta.use_bvh == (layout == "soup")
    o, d = _rays()
    eps = float(scene.pack.ray_eps)
    if query == "closest":
        tmin = jnp.full((N_RAYS,), eps)
        tmax = jnp.full((N_RAYS,), jnp.inf)
        hit = jax.jit(lambda o, d: scene_pack.intersect(
            scene.meta, scene.pack, o, d, tmin, tmax))(o, d)
        valid, t = np.asarray(hit.valid), np.asarray(hit.t)
    else:
        # segments that end inside the mesh cloud: any-hit must find a
        # blocker whenever brute force finds one before the end point
        dist = jnp.asarray(
            np.random.default_rng(1).uniform(3.0, 9.0, N_RAYS), jnp.float32)
        p_to = o + dist[:, None] * d
        tmin = jnp.full((N_RAYS,), eps)
        tmax = dist - eps
        valid = np.asarray(jax.jit(lambda a, b: scene_pack.occluded(
            scene.meta, scene.pack, a, b))(o, p_to))
    ref_valid, ref_t = brute_force(o, d, tmin, tmax, world_triangles(scene))
    assert 0.15 < ref_valid.mean() < 0.95, ref_valid.mean()
    assert (valid != ref_valid).mean() <= MAX_FLIPS
    if query == "closest":
        both = valid & ref_valid
        np.testing.assert_allclose(t[both], ref_t[both], rtol=T_RTOL)
