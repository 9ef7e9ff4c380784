"""Ray reordering between bounces: liveness compaction + coherence sorting.

XLA programs have static shapes, so paths are never physically removed
from the wave (SURVEY.md §7's wavefront-compaction experiment); instead
lanes are *permuted* so that

  * dead lanes cluster at the tail, and
  * live lanes sort by origin Morton code, then by direction octant, so
    neighbouring lanes tend to visit the same BVH nodes.

The estimate is identical with or without the permutation. Off by default
(`sort_rays=False` in models/integrators.py, `sort=False` in
scene/pack.occluded).

The reference has no analogue (one CPU thread per tile never diverges); this
replaces the warp-compaction / ray-binning step of GPU wavefront tracers.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def mesh_root_sphere(tris_mt: np.ndarray) -> np.ndarray:
    """[4] f32 bounding sphere (cx, cy, cz, r) of a [T,9] Moller-Trumbore
    triangle table (p0, e1, e2), for the needs-BVH pre-test below."""
    a = np.asarray(tris_mt, np.float64)
    if len(a) == 0:
        return np.zeros(4, np.float32)
    p0, e1, e2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    v = np.concatenate([p0, p0 + e1, p0 + e2], axis=0)
    c = 0.5 * (v.min(axis=0) + v.max(axis=0))
    r = float(np.sqrt(((v - c) ** 2).sum(axis=1).max())) * (1 + 1e-6)
    return np.array([c[0], c[1], c[2], r], np.float32)


def morton_pixel_ids(width: int) -> np.ndarray:
    """Pixel ids of a width x width image in 2D Morton order, so that a
    contiguous run of lanes covers a compact square block of the screen
    instead of a scanline."""
    xs = np.arange(width, dtype=np.uint32)

    def spread(v):
        v = v & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    gx, gy = np.meshgrid(xs, xs)
    code = spread(gx) | (spread(gy) << 1)
    flat = (gy * width + gx).ravel()
    return flat[np.argsort(code.ravel(), kind="stable")].astype(np.int32)


def _part1by2(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 7 bits of x so there are 2 zero bits between each
    (Morton interleave helper)."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0700F
    x = (x | (x << 4)) & 0x430C3
    x = (x | (x << 2)) & 0x49249
    return x


def morton3(q: jnp.ndarray) -> jnp.ndarray:
    """21-bit Morton code from [N,3] integer coords in [0, 127]."""
    return (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << 1)
        | (_part1by2(q[:, 2]) << 2)
    )


def ray_sort_key(active, o, d, world_lo, world_inv,
                 needs_bvh=None) -> jnp.ndarray:
    """Sort key per lane: (dead, [no-BVH-work], origin Morton, octant).

    world_lo: [3] scene AABB min; world_inv: [3] 1/extent. Dead lanes get
    the largest keys so live rays pack densely at the front of the wave.

    needs_bvh: optional [N] bool — live lanes whose ray cannot touch any
    BVH root sphere sort BEHIND the ones that can, so the lanes that need
    a walk sit together. See bvh_needed().

    Origin-major, octant-minor: bounce-ray origins are hit points, so fine
    spatial clustering groups rays that will visit the same nodes."""
    q = jnp.clip(
        ((o - world_lo) * world_inv * 128.0).astype(jnp.int32), 0, 127
    )
    code = morton3(q)
    octant = (
        (d[:, 0] > 0).astype(jnp.int32)
        | ((d[:, 1] > 0).astype(jnp.int32) << 1)
        | ((d[:, 2] > 0).astype(jnp.int32) << 2)
    )
    key = (code << 3) | octant
    if needs_bvh is not None:
        key = key | jnp.where(needs_bvh, 0, jnp.int32(1 << 25))
    return jnp.where(active, key, jnp.int32(1 << 26))


def bvh_needed(meta, pack, o, d, tmin, tmax) -> jnp.ndarray:
    """[N] bool: could the ray segment touch ANY BVH root sphere?

    A ~30-flop/lane/instance dense pre-test that feeds the sort keys: most
    bounce/shadow rays in an instanced scene miss every instance, and
    packing the misses together keeps them out of the walk's lanes.
    Conservative: padding-radius slack over-includes only."""
    n = o.shape[0]
    need = jnp.zeros((n,), bool)

    def seg_hits_sphere(c, r):
        oc = c[None, :] - o
        tc = jnp.sum(oc * d, axis=-1)
        m2 = jnp.sum(oc * oc, axis=-1) - tc * tc
        return ((m2 <= r * r * 1.0001 + 1e-5)
                & (tc + r >= tmin) & (tc - r <= tmax) & (tmax >= tmin))

    if meta.use_bvh and meta.n_tri:
        root = pack.bvh_root
        need = need | seg_hits_sphere(root[0:3], root[3])
    for mi in range(len(meta.n_inst)):
        root = pack.inst_root[mi]
        c_l = root[0:3]
        r_l = root[3]
        for i in range(meta.n_inst[mi]):
            c = c_l * pack.inst_scale[mi][i] + pack.inst_off[mi][i]
            need = need | seg_hits_sphere(
                c, r_l * pack.inst_scale[mi][i])
    return need


def shadow_sort_key(meta, pack, alive, o, d, tmin, tmax) -> jnp.ndarray:
    """Shadow-batch key: (dead, no-BVH-work, direction octant, origin
    Morton) — octant-major works better than origin-major for shadow
    bundles, whose origins are already coherent from the parent sort."""
    need = bvh_needed(meta, pack, o, d, tmin, tmax)
    octant = (
        (d[:, 0] > 0).astype(jnp.int32)
        | ((d[:, 1] > 0).astype(jnp.int32) << 1)
        | ((d[:, 2] > 0).astype(jnp.int32) << 2)
    )
    world_lo = pack.world_center - pack.world_radius
    world_inv = 1.0 / jnp.maximum(2.0 * pack.world_radius, 1e-12)
    q = jnp.clip(((o - world_lo) * world_inv * 128.0).astype(jnp.int32),
                 0, 127)
    code = morton3(q)
    key = code | (octant << 21) | jnp.where(need, 0, jnp.int32(1 << 24))
    return jnp.where(alive, key, jnp.int32(1 << 30))
