"""Bounding-volume hierarchy: host-side build, flattened skip-link layout,
stackless batched traversal.

Array-based replacement for the reference's recursive pointer BVH
(reference: src/bvh.h:54-146). Three deliberate design divergences, all
documented in SURVEY.md §7:

* Build axis: the reference splits on a *random* axis seeded by libc rand
  (reference: src/bvh.h:61); we split the longest axis of the centroid
  bounds (deterministic, and a strictly better partition).
* Layout: instead of heap nodes with child pointers, nodes are flattened in
  DFS preorder into SoA arrays with a *miss link* (skip pointer): on an AABB
  hit the next node is simply `i+1`; on a miss (or after a leaf) it is
  `miss[i]`. Traversal needs no stack at all — each ray carries one int32 —
  which is exactly what a lockstep SIMD while-loop wants.
* Leaves hold exactly `LEAF_SIZE` slots (padded by duplicating the last
  triangle), so the leaf-intersection loop is a static unroll with no
  dynamic trip count (the reference's leaves hold <=5, reference: src/bvh.h:15).

The traversal is a single `lax.while_loop` over the whole ray batch: every
live ray advances one node per iteration; finished rays idle until the batch
drains. Ray coherence (camera tiles) keeps the lockstep loss small.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .intersect import KindHit

LEAF_SIZE = 4


def build_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
              leaf_size: int = LEAF_SIZE, method: str = "auto"):
    """Build a BVH over triangles and flatten it.

    method: "auto" prefers the native binned-SAH builder
    (native/bvh_build.cc via ctypes) and falls back to this module's numpy
    median-split builder; "sah" requires native; "median" forces numpy.
    Both emit the identical flattened skip-link layout.
    """
    if method in ("auto", "sah"):
        from ..utils.native import try_build_bvh_native

        out = try_build_bvh_native(p0, p1, p2, leaf_size, use_sah=True)
        if out is not None:
            return out
        if method == "sah":
            raise RuntimeError("native BVH builder unavailable; run "
                               "`make -C native`")
    return _build_bvh_median(p0, p1, p2, leaf_size)


def build_box_bvh(bmin_in: np.ndarray, bmax_in: np.ndarray,
                  leaf_size: int = LEAF_SIZE):
    """Median-split BVH over arbitrary boxes (numpy builder).

    Returns ((bmin[B,3], bmax[B,3], miss[B], leaf_first[B], leaf_count[B]),
    order[K']) where `order` is the box permutation+padding that makes every
    leaf's boxes contiguous and exactly `leaf_size` long (padding duplicates
    the leaf's last real box — harmless for closest-hit).
    leaf_first = -1 marks inner nodes.

    Used both for triangle BVHs (via `_build_bvh_median`) and for the TLAS
    over instance world bounds (scene/builder.py, leaf_size=1)."""
    tri_bmin = np.asarray(bmin_in, np.float32)
    tri_bmax = np.asarray(bmax_in, np.float32)
    t = len(tri_bmin)
    centers = 0.5 * (tri_bmin + tri_bmax)

    # pass 1: build the tree as index arrays + subtree node counts
    tree = []  # rows: [bmin, bmax, left_child_row or -1, tri_indices or None]

    def rec(idx: np.ndarray) -> int:
        row = len(tree)
        bb_min = tri_bmin[idx].min(0)
        bb_max = tri_bmax[idx].max(0)
        tree.append([bb_min, bb_max, -1, -1, None, 1])
        if len(idx) <= leaf_size:
            tree[row][4] = idx
            return row
        axis = int(np.argmax(bb_max - bb_min))
        ordered = idx[np.argsort(centers[idx, axis], kind="stable")]
        half = len(ordered) // 2
        l = rec(ordered[:half])
        r = rec(ordered[half:])
        tree[row][2] = l
        tree[row][3] = r
        tree[row][5] = 1 + tree[l][5] + tree[r][5]
        return row

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(np.arange(t))
    finally:
        sys.setrecursionlimit(old_limit)

    # pass 2: DFS-preorder flatten with skip (miss) links
    n_nodes = tree[0][5]
    bmin = np.zeros((n_nodes, 3), np.float32)
    bmax = np.zeros((n_nodes, 3), np.float32)
    miss = np.zeros((n_nodes,), np.int32)
    leaf_first = np.full((n_nodes,), -1, np.int32)
    leaf_count = np.zeros((n_nodes,), np.int32)
    order: list[int] = []

    def emit(row: int, skip: int) -> None:
        stack = [(row, skip)]
        while stack:
            row, skip = stack.pop()
            i = len(emit.seen)
            emit.seen.append(row)
            bmin[i], bmax[i] = tree[row][0], tree[row][1]
            miss[i] = skip
            idx = tree[row][4]
            if idx is not None:
                first = len(order)
                padded = list(idx) + [idx[-1]] * (leaf_size - len(idx))
                order.extend(padded)
                leaf_first[i] = first
                leaf_count[i] = len(idx)
            else:
                l, r = tree[row][2], tree[row][3]
                right_start = i + 1 + tree[l][5]
                # LIFO: push right first so left is emitted at i+1
                stack.append((r, skip))
                stack.append((l, right_start))

    emit.seen = []
    emit(0, n_nodes)
    return (bmin, bmax, miss, leaf_first, leaf_count), np.asarray(order, np.int64)


def _build_bvh_median(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                      leaf_size: int = LEAF_SIZE):
    """Median-split BVH over triangles (numpy reference builder)."""
    tri_bmin = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tri_bmax = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    # pad degenerate (axis-thin) boxes like CheckThinness
    # (reference: src/geometry.h:299-304)
    thin = (tri_bmax - tri_bmin) < 1e-4
    tri_bmin = np.where(thin, tri_bmin - 1e-4, tri_bmin)
    tri_bmax = np.where(thin, tri_bmax + 1e-4, tri_bmax)
    return build_box_bvh(tri_bmin, tri_bmax, leaf_size)


def pack_node_table(bvh, order_len: int, leaf_size: int = LEAF_SIZE):
    """Bundle a builder result into the [B,8] node table the traversals use:
    bmin.xyz, bmax.xyz, miss-link, leaf-code; -1 marks inner nodes.

    Leaf code = leaf_id * 32 + count with leaf_id = leaf_first / leaf_size
    (leaf_first is always a multiple of leaf_size — leaves are padded
    contiguous), count <= 31. Control fields ride in f32 lanes; ints are
    exact in f32 only below 2^24, so refuse a table whose leaf codes would
    silently round (>= 2^19 leaves)."""
    bmin, bmax, miss, leaf_first, leaf_count = bvh
    assert leaf_size <= 31, "leaf count field is 5 bits"
    n_leaves = order_len // leaf_size
    assert 32 * n_leaves + 32 < 2 ** 24, (
        f"{n_leaves} leaves overflow the f32 leaf-code encoding; "
        "split the scene or widen the control fields"
    )
    leaf_code = np.where(
        leaf_first >= 0, (leaf_first // leaf_size) * 32 + leaf_count, -1
    ).astype(np.float32)
    return np.concatenate(
        [bmin, bmax, miss[:, None].astype(np.float32), leaf_code[:, None]],
        axis=1,
    ).astype(np.float32)


def intersect_bvh(nodes, tris, o, d, tmin, tmax,
                  leaf_size: int = LEAF_SIZE,
                  any_hit: bool = False) -> KindHit:
    """Batched stackless closest-hit traversal over a flattened BVH.

    nodes: [B,8] node table (pack_node_table); tris: [T',9] MT-ready
    (p0, e1, e2) rows. Replaces the recursive traverse-both-children scheme
    (reference: src/bvh.h:94-146) with a skip-link walk; the functional
    `t_best` min-update replaces the reference's mutable ray.max_t shrink.

    any_hit=True is the occlusion variant: the first accepted triangle hit
    sets t_best = 0, which fails every subsequent slab interval test — the
    ray goes inert immediately instead of refining the closest hit. The
    reference has no dedicated any-hit path (SURVEY.md quirk list: it runs
    full closest-hit traces for shadows, reference: src/scene.h:36-52);
    returned t is meaningless (0), only `valid` matters.
    """
    n_nodes = nodes.shape[0]
    n_tris = tris.shape[0]

    safe_d = jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    inv_d = 1.0 / safe_d
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ix, iy, iz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

    # Two-phase lockstep traversal. Phase 1 (inner while): every live lane
    # steps node-to-node — ONE bundled gather + slab test per step — until
    # it either finishes or parks on a hit leaf. Phase 2 (outer body):
    # LEAF_SIZE triangles of the parked leaves are intersected. Leaf work is
    # the expensive part (4 more gathers + Möller-Trumbore), and this split
    # makes its cost proportional to leaves *visited* rather than to the
    # worst ray's total node count.

    def inner_body(state):
        node, pend, t_best = state
        stepping = (node < n_nodes) & (pend < 0)
        nd = jnp.minimum(node, n_nodes - 1)
        row = nodes[nd]                                # [N,8]
        t0x = (row[:, 0] - ox) * ix
        t0y = (row[:, 1] - oy) * iy
        t0z = (row[:, 2] - oz) * iz
        t1x = (row[:, 3] - ox) * ix
        t1y = (row[:, 4] - oy) * iy
        t1z = (row[:, 5] - oz) * iz
        t_enter = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        t_exit = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        box_hit = (t_enter <= t_exit) & (t_exit > tmin) & (
            t_enter < jnp.minimum(tmax, t_best)
        ) & stepping

        miss_link = row[:, 6].astype(jnp.int32)
        leaf_code = row[:, 7].astype(jnp.int32)
        is_leaf = leaf_code >= 0
        park = box_hit & is_leaf

        pend = jnp.where(park, leaf_code, pend)
        nxt = jnp.where(box_hit & ~is_leaf, node + 1, miss_link)
        node = jnp.where(stepping, nxt, node)
        return node, pend, t_best

    def inner_cond(state):
        node, pend, _ = state
        return jnp.any((node < n_nodes) & (pend < 0))

    def outer_body(state):
        node, t_best, idx_best, pend = state
        node, pend, _ = lax.while_loop(
            inner_cond, inner_body, (node, pend, t_best)
        )
        has_leaf = pend >= 0
        first = (jnp.maximum(pend, 0) // 32) * leaf_size
        count = jnp.maximum(pend, 0) % 32
        # static leaf_size-way unrolled Möller-Trumbore; one bundled
        # (p0, e1, e2) gather per slot
        for k in range(leaf_size):
            ti = jnp.clip(first + k, 0, max(n_tris - 1, 0))
            tr = tris[ti]                               # [N,9]
            ax_, ay_, az_ = tr[:, 0], tr[:, 1], tr[:, 2]
            e1x, e1y, e1z = tr[:, 3], tr[:, 4], tr[:, 5]
            e2x, e2y, e2z = tr[:, 6], tr[:, 7], tr[:, 8]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
            tx = ox - ax_
            ty = oy - ay_
            tz = oz - az_
            uu = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            vv = (dx * qx + dy * qy + dz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = (
                has_leaf
                & (k < count)
                & (jnp.abs(det) > 1e-12)
                & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                & (tt > tmin) & (tt < jnp.minimum(tmax, t_best))
            )
            t_best = jnp.where(ok, 0.0 if any_hit else tt, t_best)
            idx_best = jnp.where(ok, ti.astype(jnp.int32), idx_best)
        pend = jnp.full_like(pend, -1)
        return node, t_best, idx_best, pend

    def outer_cond(state):
        node, _, _, pend = state
        return jnp.any((node < n_nodes) | (pend >= 0))

    # the initial carries take the type of the per-ray inputs, so that
    # under shard_map they vary over the same mesh axes as the loop
    # body's outputs
    ray = ox + dx + tmin + tmax
    node0 = jnp.zeros_like(ray, jnp.int32)
    t_best0 = jnp.full_like(ray, jnp.inf)
    idx0 = jnp.zeros_like(ray, jnp.int32)
    pend0 = jnp.full_like(ray, -1, jnp.int32)
    _, t_best, idx_best, _ = lax.while_loop(
        outer_cond, outer_body, (node0, t_best0, idx0, pend0)
    )
    return KindHit(t=t_best, index=idx_best, valid=jnp.isfinite(t_best))


def intersect_instances(inst_off, inst_scale, blas_nodes, blas_tris,
                        o, d, tmin, tmax,
                        leaf_size: int = LEAF_SIZE,
                        any_hit: bool = False) -> KindHit:
    """Closest hit over instanced copies of one BLAS (XLA path).

    Two-level acceleration: each instance is (uniform scale, translation) of
    a shared triangle mesh + BVH — the batched answer to the reference's
    four separately-loaded bunny copies (reference: src/main.cc:94-107),
    shrinking the hot node/triangle tables by the instance count. Rays are
    transformed into instance space (o' = (o-off)/s, d unchanged, t' = t/s)
    and the winning hit is re-expressed in world units. The per-instance
    `tmax` shrink carries the best-so-far across instances, so later
    instances traverse against an already-tight ray interval.

    Returns hit indices encoded as instance * n_blas_tris + triangle.
    """
    n_blas_tris = blas_tris.shape[0]

    def one_instance(i, best):
        t_best, idx_best = best
        s = inst_scale[i]
        inv = 1.0 / s
        o_l = (o - inst_off[i]) * inv
        h = intersect_bvh(blas_nodes, blas_tris, o_l, d,
                          tmin * inv, jnp.minimum(tmax, t_best) * inv,
                          leaf_size=leaf_size, any_hit=any_hit)
        t_w = h.t * s
        closer = h.valid & (t_w < t_best)
        return (jnp.where(closer, t_w, t_best),
                jnp.where(closer, i * n_blas_tris + h.index, idx_best))

    # one traced walk, looped over instances (not unrolled per instance)
    ray = o[:, 0] + d[:, 0] + tmin + tmax
    t_best, idx_best = lax.fori_loop(
        0, inst_off.shape[0], one_instance,
        (jnp.full_like(ray, jnp.inf), jnp.zeros_like(ray, jnp.int32)))
    return KindHit(t=t_best, index=idx_best, valid=jnp.isfinite(t_best))
