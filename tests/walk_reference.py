"""Brute-force reference for scene intersection: every ray against every
world-space triangle of a scene, in chunks, with `intersect_triangles`.

Used by tests/test_walk.py at small sizes and by chip_smoke.py at the
bunny scene's full size.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from jet_pbrt_tpu.ops import intersect as isect_ops
from jet_pbrt_tpu.ops.intersect import NO_HIT_T


def world_triangles(scene) -> np.ndarray:
    """[T,9] world-space (p0, e1, e2) rows of every surface intersect() can
    hit: triangles (the soup, or the soup BVH's table), each instance's
    copy of its BLAS (leaf padding duplicates some rows, which cannot
    change a hit), and each rectangle as two triangles."""
    meta, pack = scene.meta, scene.pack
    assert not (meta.n_sph or meta.n_disk), "triangles and rects only"

    def mt(p0, p1, p2):
        return np.concatenate([p0, p1 - p0, p2 - p0], axis=1)

    rows = []
    if meta.n_tri:
        rows.append(np.asarray(pack.bvh_tris) if meta.use_bvh else mt(
            *(np.asarray(getattr(pack, f)) for f in ("tri_p0", "tri_p1",
                                                     "tri_p2"))))
    for mi in range(len(meta.n_inst)):
        tris = np.asarray(pack.blas_tris[mi])
        for off, s in zip(np.asarray(pack.inst_off[mi]),
                          np.asarray(pack.inst_scale[mi])):
            w = tris * s
            w[:, 0:3] += off
            rows.append(w)
    if meta.n_rect:
        q = np.asarray(pack.rect_q)
        rows += [mt(q[:, 0], q[:, 1], q[:, 2]), mt(q[:, 0], q[:, 2], q[:, 3])]
    return np.concatenate(rows).astype(np.float32)


@jax.jit
def _closest(o, d, tmin, tmax, tris):
    """Closest t over [C,K,9] triangle chunks, scanned."""
    def step(t_best, chunk):
        p0 = chunk[:, 0:3]
        h = isect_ops.intersect_triangles(
            o, d, tmin, tmax, p0, p0 + chunk[:, 3:6], p0 + chunk[:, 6:9])
        return jnp.minimum(t_best, jnp.where(h.valid, h.t, NO_HIT_T)), None

    t0 = jnp.full(o.shape[:1], NO_HIT_T, jnp.float32)
    t, _ = jax.lax.scan(step, t0, tris)
    return t


def brute_force(o, d, tmin, tmax, tris: np.ndarray,
                ray_chunk: int = 16384, tri_chunk: int = 2048):
    """Closest hit of every ray over every row of `tris` ([T,9] world
    (p0, e1, e2)). Returns (valid [N] bool, t [N]) as numpy arrays."""
    n_tri = len(tris)
    tri_chunk = min(tri_chunk, n_tri)
    pad = (-n_tri) % tri_chunk
    # padding rows are degenerate (zero edges) and never hit
    tris = np.concatenate([tris, np.zeros((pad, 9), np.float32)])
    tris = jnp.asarray(tris.reshape(-1, tri_chunk, 9))
    out = []
    for r0 in range(0, o.shape[0], ray_chunk):
        sl = slice(r0, r0 + ray_chunk)
        out.append(np.asarray(_closest(o[sl], d[sl], tmin[sl], tmax[sl],
                                       tris)))
    t = np.concatenate(out)
    return np.isfinite(t), t
