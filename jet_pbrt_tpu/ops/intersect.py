"""Batched ray ↔ shape intersection kernels.

Batched replacement for the reference's virtual FShape::Intersect scalar
methods (reference: src/shape.h:200-221 disk, 291-327 triangle, 399-435
rectangle, 487-526 sphere). Design: geometry lives in SoA device arrays, one
array family per shape kind, and each kernel intersects a whole ray batch
against a whole shape batch at once — pure elementwise work with no
divergence. The reference's mutable `ray.max_t` shrinking becomes a
functional min-reduction over candidate ts.

Convention: a ray is (o, d, tmin, tmax) with d unit length; a "kind hit" is
the tuple (t, index, valid) of per-ray closest hit among shapes of that kind.
Closest-hit across kinds is a simple min-merge (see `merge_hits`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .linalg import cross, dot, normalize, RAY_EPS


class KindHit(NamedTuple):
    t: jnp.ndarray      # [N] hit distance (inf if none)
    index: jnp.ndarray  # [N] int32 index into the kind's shape arrays
    valid: jnp.ndarray  # [N] bool


NO_HIT_T = jnp.float32(jnp.inf)


def _closest(t_nm: jnp.ndarray, valid_nm: jnp.ndarray) -> KindHit:
    """Reduce [N, M] candidate hits to the per-ray closest."""
    t_masked = jnp.where(valid_nm, t_nm, NO_HIT_T)
    idx = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t = jnp.min(t_masked, axis=1)
    return KindHit(t=t, index=idx, valid=jnp.isfinite(t))


def _closest_mn(t_mn: jnp.ndarray, valid_mn: jnp.ndarray) -> KindHit:
    """Reduce [M, N] (shape-major) candidates to the per-ray closest.

    Shape-major orientation keeps the big ray axis minor (contiguous), so
    the candidate math vectorizes over rays rather than over a small
    shape count."""
    t_masked = jnp.where(valid_mn, t_mn, NO_HIT_T)
    idx = jnp.argmin(t_masked, axis=0).astype(jnp.int32)
    t = jnp.min(t_masked, axis=0)
    return KindHit(t=t, index=idx, valid=jnp.isfinite(t))


def _c3(a):
    """Split [K,3] into scalar component columns."""
    return a[..., 0], a[..., 1], a[..., 2]


def empty_hit(n: int) -> KindHit:
    return KindHit(
        t=jnp.full((n,), NO_HIT_T),
        index=jnp.zeros((n,), jnp.int32),
        valid=jnp.zeros((n,), bool),
    )


# ---------------------------------------------------------------------------
# Triangles — Möller-Trumbore. Mathematically equivalent hit set / t to the
# reference's SmallVCM sign-consistency test (reference: src/shape.h:291-327)
# but branch-free and it yields barycentrics for UV interpolation.
# ---------------------------------------------------------------------------

def intersect_triangles(o, d, tmin, tmax, p0, p1, p2) -> KindHit:
    """o,d: [N,3]; p0,p1,p2: [T,3]. Shape-major [T,N] component math — the
    ray axis stays minor (use the BVH walk for large T)."""
    ox, oy, oz = (c[None, :] for c in _c3(o))        # [1,N]
    dx, dy, dz = (c[None, :] for c in _c3(d))
    p0x, p0y, p0z = (c[:, None] for c in _c3(p0))    # [T,1]
    e1x, e1y, e1z = (c[:, None] for c in _c3(p1 - p0))
    e2x, e2y, e2z = (c[:, None] for c in _c3(p2 - p0))

    # pvec = d x e2                                   [T,N]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    # tvec = o - p0
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > tmin[None, :]) & (t < tmax[None, :])
    )
    return _closest_mn(t, valid)


def triangle_normal(p0, p1, p2, flip=None) -> jnp.ndarray:
    """Face normal per triangle (reference: src/shape.h:284-286); one normal
    per face, no shading-normal interpolation — matching the reference, which
    discards loaded OBJ normals (reference: src/shape.cc:38-65)."""
    n = normalize(cross(p1 - p0, p2 - p0))
    if flip is not None:
        n = jnp.where(flip[:, None], -n, n)
    return n


# ---------------------------------------------------------------------------
# Spheres (reference: src/shape.h:487-526).
# ---------------------------------------------------------------------------

def intersect_spheres(o, d, tmin, tmax, center, radius) -> KindHit:
    """center: [S,3], radius: [S]. Shape-major [S,N] component math."""
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))
    cx, cy, cz = (c[:, None] for c in _c3(center))
    r = radius[:, None]
    ocx = cx - ox
    ocy = cy - oy
    ocz = cz - oz
    b = ocx * dx + ocy * dy + ocz * dz               # [S,N]
    det = b * b - (ocx * ocx + ocy * ocy + ocz * ocz) + r * r
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    t_near = b - sq
    t_far = b + sq
    in_near = (t_near > tmin[None, :]) & (t_near < tmax[None, :])
    in_far = (t_far > tmin[None, :]) & (t_far < tmax[None, :])
    t = jnp.where(in_near, t_near, t_far)
    valid = (det >= 0.0) & (in_near | in_far)
    return _closest_mn(t, valid)


# ---------------------------------------------------------------------------
# Rectangles — convex-quad sign test, same predicate as the reference
# (reference: src/shape.h:399-435). Quad corners p0..p3 in loop order; the
# geometric normal is Cross(p1-p0, p2-p0) with optional flip at build.
# ---------------------------------------------------------------------------

def intersect_rects(o, d, tmin, tmax, q0, q1, q2, q3, n) -> KindHit:
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))

    def corner(q):
        qx, qy, qz = (c[:, None] for c in _c3(q))
        return qx - ox, qy - oy, qz - oz             # [R,N] comps

    ax, ay, az = corner(q0)
    bx, by, bz = corner(q1)
    cx, cy, cz = corner(q2)
    ex, ey, ez = corner(q3)

    def cross_dot_d(ux, uy, uz, vx, vy, vz):
        return (
            (uy * vz - uz * vy) * dx
            + (uz * vx - ux * vz) * dy
            + (ux * vy - uy * vx) * dz
        )

    v0d = cross_dot_d(cx, cy, cz, bx, by, bz)
    v1d = cross_dot_d(bx, by, bz, ax, ay, az)
    v2d = cross_dot_d(ax, ay, az, ex, ey, ez)
    v3d = cross_dot_d(ex, ey, ez, cx, cy, cz)
    same_neg = (v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)
    same_pos = (v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0)
    inside = same_neg | same_pos
    nx, ny, nz = (c[:, None] for c in _c3(n))
    denom = nx * dx + ny * dy + nz * dz
    t = jnp.where(
        jnp.abs(denom) > 1e-12, (nx * ax + ny * ay + nz * az) / denom, NO_HIT_T
    )
    valid = inside & (t > tmin[None, :]) & (t < tmax[None, :])
    return _closest_mn(t, valid)


def rect_hit_normal(n_gathered: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Rect normals face the ray (reference: src/shape.h:427)."""
    return jnp.where(dot(n_gathered, d)[:, None] <= 0.0, n_gathered, -n_gathered)


# ---------------------------------------------------------------------------
# Disks (reference: src/shape.h:200-221). Canonical (unflipped) normal.
# ---------------------------------------------------------------------------

def intersect_disks(o, d, tmin, tmax, center, n, radius) -> KindHit:
    ox, oy, oz = (c[None, :] for c in _c3(o))
    dx, dy, dz = (c[None, :] for c in _c3(d))
    cx, cy, cz = (c[:, None] for c in _c3(center))
    nx, ny, nz = (c[:, None] for c in _c3(n))
    denom = nx * dx + ny * dy + nz * dz              # [D,N]
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    t = jnp.where(
        jnp.abs(denom) > 1e-9, (nx * opx + ny * opy + nz * opz) / denom,
        NO_HIT_T,
    )
    hx = ox + t * dx - cx
    hy = oy + t * dy - cy
    hz = oz + t * dz - cz
    r2 = hx * hx + hy * hy + hz * hz
    valid = (
        (jnp.abs(denom) > 1e-9)
        & (t > tmin[None, :]) & (t < tmax[None, :])
        & (r2 <= (radius[:, None] ** 2))
    )
    return _closest_mn(t, valid)


# ---------------------------------------------------------------------------
# Merging hits across shape kinds.
# ---------------------------------------------------------------------------

def merge_hits(hits: list[KindHit], kinds: list[int]):
    """Min-merge per-kind closest hits. Returns (t, kind, index, valid)."""
    t = hits[0].t
    kind = jnp.full_like(hits[0].index, kinds[0])
    index = hits[0].index
    for h, k in zip(hits[1:], kinds[1:]):
        closer = h.t < t
        t = jnp.where(closer, h.t, t)
        kind = jnp.where(closer, k, kind)
        index = jnp.where(closer, h.index, index)
    return t, kind, index, jnp.isfinite(t)


def offset_ray_origin(p: jnp.ndarray) -> tuple[jnp.ndarray, float]:
    """Spawned rays start at the hit point with tmin = 1e-3, the reference's
    shadow epsilon (reference: src/geometry.h:395-396, src/shape.h:61-76)."""
    return p, RAY_EPS
