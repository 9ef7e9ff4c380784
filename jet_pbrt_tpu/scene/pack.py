"""ScenePack: the whole scene as a pytree of packed SoA device arrays.

Array-batched replacement for the reference's FScene registry of shared_ptr
object graphs (reference: src/scene.h:130-143) and FPrimitive
{shape*, material*, arealight*} triples (reference: src/primitive.h:20-64).
A primitive here is a row: geometry arrays carry parallel `*_mat` and
`*_light` int32 columns (light = -1 when not emissive), and "virtual
dispatch" is a static Python loop over the (small, host-known) set of shape
kinds plus per-lane selects.

Static facts about the scene (array sizes, light descriptors) live in
`SceneMeta`, a hashable dataclass passed as a static jit argument; everything
numeric — including every differentiable parameter (material colors,
roughness, light radiance) — lives in `ScenePack`, a pytree of jnp arrays.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from ..ops import intersect as isect_ops
from ..ops.linalg import dot, normalize, RAY_EPS
from ..ops.intersect import KindHit

KIND_TRI = 0
KIND_SPHERE = 1
KIND_RECT = 2
KIND_DISK = 3
KIND_INST = 4  # instanced triangle mesh family: kind id KIND_INST + mesh
               # index (multiple mesh families each share one BLAS; no
               # reference analogue — the reference re-loads the bunny OBJ
               # per copy, src/main.cc:94-107)

LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2
LIGHT_ENV = 3


@dataclasses.dataclass(frozen=True)
class LightMeta:
    """Static description of one light (its kind and, for area lights, which
    shape row it wraps). Radiance/intensity values live in ScenePack.light_c
    so they stay differentiable.

    static_black marks a light whose radiance was exactly zero at build time
    (e.g. the cornell scene's black environment light, reference:
    src/main.cc:24-25). NEE skips such lights — the reference wastes a full
    shadow-ray traversal per bounce on them. The only observable difference
    is that gradients w.r.t. that light's radiance lose their NEE term;
    build with prune_black_nee=False to keep it."""
    kind: int
    shape_kind: int = -1
    shape_idx: int = -1
    static_black: bool = False


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    name: str
    n_tri: int
    n_sph: int
    n_rect: int
    n_disk: int
    n_mat: int
    lights: tuple  # tuple[LightMeta, ...]
    use_bvh: bool = False
    n_tex: int = 0
    # static set of BSDF lobe kinds the scene's materials can resolve to;
    # None means "all" (bsdf.ALL_LOBES)
    present_lobes: tuple | None = None
    # static set of microfacet distribution kinds present (mf.GGX /
    # mf.BECKMANN); single-kind scenes compile only that branch
    present_mf_kinds: tuple | None = None
    # instanced-mesh subsystem: one entry PER MESH FAMILY (each family =
    # one shared BLAS + its instances); empty tuples = no instancing
    n_inst: tuple = ()
    n_blas_tris: tuple = ()
    # triangles per BVH leaf (static unroll factor of the walk), shared by
    # the soup BVH and every BLAS
    bvh_leaf_size: int = 4

    @property
    def n_lights(self) -> int:
        return len(self.lights)

    @property
    def env_light_indices(self) -> tuple:
        return tuple(
            i for i, l in enumerate(self.lights) if l.kind == LIGHT_ENV
        )


class ScenePack(NamedTuple):
    # triangles
    tri_p0: jnp.ndarray     # [T,3]
    tri_p1: jnp.ndarray
    tri_p2: jnp.ndarray
    tri_n: jnp.ndarray      # [T,3] fixed face normal (reference: src/shape.h:284-286)
    tri_uv: jnp.ndarray     # [T,3,2] per-vertex texcoords (from OBJ)
    tri_mat: jnp.ndarray    # [T] int32
    tri_light: jnp.ndarray  # [T] int32, -1 = not emissive
    # spheres
    sph_c: jnp.ndarray      # [S,3]
    sph_r: jnp.ndarray      # [S]
    sph_mat: jnp.ndarray
    sph_light: jnp.ndarray
    # rectangles (convex quads, corners in loop order p0..p3)
    rect_q: jnp.ndarray     # [R,4,3]
    rect_n: jnp.ndarray     # [R,3] canonical normal
    rect_mat: jnp.ndarray
    rect_light: jnp.ndarray
    # disks
    disk_c: jnp.ndarray     # [D,3]
    disk_n: jnp.ndarray     # [D,3]
    disk_r: jnp.ndarray     # [D]
    disk_mat: jnp.ndarray
    disk_light: jnp.ndarray
    # material table (reference: src/material.h; kinds in ops/bsdf.py)
    mat_kind: jnp.ndarray   # [M] int32
    mat_c0: jnp.ndarray     # [M,3]
    mat_c1: jnp.ndarray     # [M,3]
    mat_s0: jnp.ndarray     # [M]
    mat_s1: jnp.ndarray     # [M]
    mat_remap: jnp.ndarray  # [M] bool
    mat_tex: jnp.ndarray    # [M] int32 texture id for Kd, -1 = none
    mat_mf: jnp.ndarray     # [M] int32 microfacet kind (mf.GGX/mf.BECKMANN)
    # texture table (ops/texture.py kinds)
    tex_kind: jnp.ndarray   # [K] int32
    tex_c0: jnp.ndarray     # [K,3]
    tex_c1: jnp.ndarray     # [K,3]
    tex_scale: jnp.ndarray  # [K]
    tex_image: jnp.ndarray  # [K,TH,TW,3] padded image data
    tex_wh: jnp.ndarray     # [K,2] int32 actual (w,h)
    # light parameter table (kinds are static, in SceneMeta.lights)
    light_c: jnp.ndarray    # [L,3] radiance / intensity / irradiance
    light_pos: jnp.ndarray  # [L,3]
    light_dir: jnp.ndarray  # [L,3]
    # world bounding sphere (reference: src/scene.cc:35-45, light Preprocess)
    world_center: jnp.ndarray  # [3]
    world_radius: jnp.ndarray  # []
    # scale-relative spawn/shadow ray epsilon (RAY_EPS_REL x scene
    # diameter by default; build(ray_eps=...) pins the reference's 1e-3)
    ray_eps: jnp.ndarray       # []
    # flattened skip-link BVH over triangles (empty when meta.use_bvh=False).
    # Bundled into single tables so each traversal step costs ONE gather:
    #   bvh_nodes[B, 8] = bmin.xyz, bmax.xyz, miss-link, leaf-code
    #     (leaf-code = first*8 + count for leaves, -1 for inner nodes;
    #      exact in f32 below 2^24)
    #   bvh_tris[T', 9] = p0.xyz, e1.xyz, e2.xyz (MT-ready edges)
    bvh_nodes: jnp.ndarray      # [B,8] f32
    bvh_tris: jnp.ndarray       # [T',9] f32
    bvh_root: jnp.ndarray       # [4] f32 bounding sphere (c.xyz, r) of
                                # bvh_tris, for the sort-key pre-test
    # instanced-mesh subsystem, one tuple entry per MESH FAMILY: a shared
    # BLAS (bottom-level BVH over the mesh in local space) + a
    # per-instance table + a TLAS over instance world bounds. Instance
    # transform is (uniform scale, translation).
    blas_nodes: tuple           # ([Bb,8] f32,)* (row layout, XLA walk)
    blas_tris: tuple            # ([Tb,9] f32,)*
    blas_n: tuple               # ([Tb,3] local-space face normals,)*
    blas_uv: tuple              # ([Tb,3,2] per-vertex texcoords,)*
    inst_off: tuple             # ([I,3] world translation,)*
    inst_scale: tuple           # ([I] uniform scale,)*
    inst_mat: tuple             # ([I] int32 material per instance,)*
    inst_light: tuple           # ([I] int32, -1 = not emissive,)*
    tlas_nodes: tuple           # ([K,8] skip-link; leaf = instance*8+1,)*
    inst_root: tuple            # ([4] f32 local BLAS bounding sphere,)*
    # emissive-instance light-sampling table: the RAW local mesh, exactly
    # one row per real triangle. blas_tris cannot be used for sampling:
    # the BVH build pads leaves by DUPLICATING triangles, which would
    # double-cover their surface and bias the area pdf. Empty unless some
    # instance carries a light.
    inst_em_tris: tuple         # ([Traw,9] f32 (p0, e1, e2),)*
    inst_em_n: tuple            # ([Traw,3] f32 unit normals,)*


class Hit(NamedTuple):
    """Batched FIntersection (reference: src/shape.h:33-77)."""
    valid: jnp.ndarray     # [N] bool
    t: jnp.ndarray         # [N]
    position: jnp.ndarray  # [N,3]
    normal: jnp.ndarray    # [N,3] geometric normal per reference semantics
    wo: jnp.ndarray        # [N,3] world-space -ray.dir
    uv: jnp.ndarray        # [N,2] surface parameterization at the hit
    mat_id: jnp.ndarray    # [N] int32 (0 when invalid — callers mask)
    light_id: jnp.ndarray  # [N] int32, -1 = not an emitter


def _kind_hits(meta: SceneMeta, pack: ScenePack, o, d, tmin, tmax,
               any_hit: bool = False):
    """Closest hit per shape kind; only kinds present in the scene are
    traced (static dispatch — array sizes are trace-time constants).

    Triangle meshes take the skip-link BVH walk (ops/bvh.py) when the scene
    was built with a BVH, brute force otherwise. any_hit=True is the
    occlusion variant: only `valid` is meaningful in the BVH kinds'
    results."""
    from ..ops import bvh as bvh_ops

    hits, kinds = [], []
    if meta.n_tri:
        if meta.use_bvh:
            hits.append(bvh_ops.intersect_bvh(
                pack.bvh_nodes, pack.bvh_tris, o, d, tmin, tmax,
                leaf_size=meta.bvh_leaf_size, any_hit=any_hit,
            ))
        else:
            hits.append(
                isect_ops.intersect_triangles(
                    o, d, tmin, tmax, pack.tri_p0, pack.tri_p1, pack.tri_p2
                )
            )
        kinds.append(KIND_TRI)
    for mi in range(len(meta.n_inst)):
        hits.append(bvh_ops.intersect_instances(
            pack.inst_off[mi], pack.inst_scale[mi],
            pack.blas_nodes[mi], pack.blas_tris[mi], o, d, tmin, tmax,
            leaf_size=meta.bvh_leaf_size, any_hit=any_hit,
        ))
        kinds.append(KIND_INST + mi)
    if meta.n_sph:
        hits.append(
            isect_ops.intersect_spheres(o, d, tmin, tmax, pack.sph_c, pack.sph_r)
        )
        kinds.append(KIND_SPHERE)
    if meta.n_rect:
        q = pack.rect_q
        hits.append(
            isect_ops.intersect_rects(
                o, d, tmin, tmax, q[:, 0], q[:, 1], q[:, 2], q[:, 3], pack.rect_n
            )
        )
        kinds.append(KIND_RECT)
    if meta.n_disk:
        hits.append(
            isect_ops.intersect_disks(
                o, d, tmin, tmax, pack.disk_c, pack.disk_n, pack.disk_r
            )
        )
        kinds.append(KIND_DISK)
    return hits, kinds


def intersect(meta: SceneMeta, pack: ScenePack, o, d, tmin, tmax,
              with_uv: bool = True) -> Hit:
    """Closest-hit over the whole scene (reference: src/scene.cc:25-33).

    UVs are only computed when the scene has textures (static check)."""
    n = o.shape[0]
    hits, kinds = _kind_hits(meta, pack, o, d, tmin, tmax)
    if not hits:
        z3 = jnp.zeros((n, 3), jnp.float32)
        return Hit(
            valid=jnp.zeros((n,), bool), t=jnp.full((n,), jnp.inf),
            position=z3, normal=z3, wo=-d, uv=jnp.zeros((n, 2), jnp.float32),
            mat_id=jnp.zeros((n,), jnp.int32),
            light_id=jnp.full((n,), -1, jnp.int32),
        )

    t, kind, index, valid = isect_ops.merge_hits(hits, kinds)
    t_safe = jnp.where(valid, t, 1.0)
    p = o + t_safe[:, None] * d

    normal = jnp.zeros((n, 3), jnp.float32)
    uv = jnp.zeros((n, 2), jnp.float32)
    mat_id = jnp.zeros((n,), jnp.int32)
    light_id = jnp.full((n,), -1, jnp.int32)
    want_uv = with_uv and meta.n_tex > 0

    def fetch(narr, marr, larr):
        """(normal-ish [*,3], mat, light) rows of the winning primitive."""
        return narr[index], marr[index], larr[index]

    for k in kinds:
        sel = kind == k
        sel3 = sel[:, None]
        if k == KIND_TRI:
            nk, mk, lk = fetch(pack.tri_n, pack.tri_mat, pack.tri_light)
            if want_uv:
                uvk = _tri_uv(pack, index, p)
        elif k == KIND_SPHERE:
            # outward normal (reference: src/shape.h:520)
            ck, mk, lk = fetch(pack.sph_c, pack.sph_mat, pack.sph_light)
            nk = normalize(p - ck)
            if want_uv:
                # lat-long on the unit normal (reference: src/shape.h:528-538,
                # corrected to use the normalized offset, not the world point)
                phi = jnp.arctan2(nk[:, 2], nk[:, 0])
                theta = jnp.arcsin(jnp.clip(nk[:, 1], -1.0, 1.0))
                uvk = jnp.stack(
                    [1.0 - (phi + jnp.pi) / (2.0 * jnp.pi),
                     (theta + jnp.pi / 2.0) / jnp.pi], axis=-1,
                )
        elif k >= KIND_INST:
            mi = k - KIND_INST
            inst = index // meta.n_blas_tris[mi]
            ti = index % meta.n_blas_tris[mi]
            off, scale, mk, lk = instance_rows(pack, mi, inst)
            nk = pack.blas_n[mi][ti]
            if want_uv:
                tri = pack.blas_tris[mi][ti]
                # barycentrics in instance-local space (transform is
                # conformal, so weights match world space; local is cheaper)
                p_l = (p - off) / jnp.maximum(scale, 1e-12)[:, None]
                a = tri[:, 0:3]
                v0 = tri[:, 3:6]       # e1 = p1 - p0
                v1 = tri[:, 6:9]       # e2 = p2 - p0
                v2 = p_l - a
                d00 = dot(v0, v0)
                d01 = dot(v0, v1)
                d11 = dot(v1, v1)
                d20 = dot(v2, v0)
                d21 = dot(v2, v1)
                denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-18)
                wb = (d11 * d20 - d01 * d21) / denom
                wc = (d00 * d21 - d01 * d20) / denom
                wa = 1.0 - wb - wc
                uvs = pack.blas_uv[mi][ti]
                uvk = (
                    uvs[:, 0] * wa[:, None] + uvs[:, 1] * wb[:, None]
                    + uvs[:, 2] * wc[:, None]
                )
        elif k == KIND_RECT:
            # rect normals face the ray (reference: src/shape.h:427)
            nk, mk, lk = fetch(pack.rect_n, pack.rect_mat, pack.rect_light)
            nk = isect_ops.rect_hit_normal(nk, d)
            if want_uv:
                # edge projection (reference: src/shape.h:437-447)
                q = pack.rect_q[index]
                v01 = q[:, 1] - q[:, 0]
                v03 = q[:, 3] - q[:, 0]
                v0p = p - q[:, 0]
                uvk = jnp.stack(
                    [dot(v01, v0p) / jnp.maximum(dot(v01, v01), 1e-12),
                     dot(v03, v0p) / jnp.maximum(dot(v03, v03), 1e-12)],
                    axis=-1,
                )
        else:
            nk, mk, lk = fetch(pack.disk_n, pack.disk_mat, pack.disk_light)
            if want_uv:
                # polar (reference: src/shape.h:223-236)
                from ..ops.linalg import frame_from_z, to_local

                c = pack.disk_c[index]
                local = to_local(frame_from_z(nk), p - c)
                phi = jnp.arctan2(local[:, 1], local[:, 0])
                phi = jnp.where(phi < 0, phi + 2 * jnp.pi, phi)
                r = jnp.sqrt(jnp.maximum(dot(p - c, p - c), 0.0))
                uvk = jnp.stack(
                    [phi / (2 * jnp.pi),
                     r / jnp.maximum(pack.disk_r[index], 1e-12)], axis=-1,
                )
        normal = jnp.where(sel3, nk, normal)
        mat_id = jnp.where(sel, mk, mat_id)
        light_id = jnp.where(sel, lk, light_id)
        if want_uv:
            uv = jnp.where(sel[:, None], uvk, uv)

    return Hit(
        valid=valid,
        t=t,
        position=p,
        normal=normal,
        wo=-d,
        uv=uv,
        mat_id=jnp.where(valid, mat_id, 0),
        light_id=jnp.where(valid, light_id, -1),
    )


def instance_rows(pack: ScenePack, mi: int, inst):
    """(offset [N,3], scale [N], material [N], light [N]) of the instances
    `inst` [N] of mesh family mi."""
    return (pack.inst_off[mi][inst], pack.inst_scale[mi][inst],
            pack.inst_mat[mi][inst], pack.inst_light[mi][inst])


def _tri_uv(pack: ScenePack, index, p):
    """Barycentric-interpolated vertex UVs for the winning triangle.

    The reference's triangle GetUV uses incorrect dot-product barycentrics
    and is unused in the render path (SURVEY.md §2 #15); this is the proper
    interpolation of the UVs the OBJ loader provides (src/shape.cc:44-46)."""
    a = pack.tri_p0[index]
    b = pack.tri_p1[index]
    c = pack.tri_p2[index]
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-18)
    wb = (d11 * d20 - d01 * d21) / denom
    wc = (d00 * d21 - d01 * d20) / denom
    wa = 1.0 - wb - wc
    uvs = pack.tri_uv[index]  # [N,3,2]
    return (
        uvs[:, 0] * wa[:, None] + uvs[:, 1] * wb[:, None] + uvs[:, 2] * wc[:, None]
    )


def occluded(meta: SceneMeta, pack: ScenePack, p_from, p_to,
             mask=None, sort: bool = False) -> jnp.ndarray:
    """Visibility between two points, ray range [eps, dist-eps]
    (reference: src/scene.h:36-52). Any hit in range occludes; unlike the
    reference — which runs a full closest-hit trace — the BVH kinds take a
    dedicated any-hit walk (first accepted hit parks the ray) and the
    brute-force kinds only keep the validity bit.

    mask: optional [N] bool; lanes with mask=False trace nothing (their
    interval is emptied so BVH tiles full of them exit immediately) and
    report unoccluded.

    sort=True permutes the shadow batch by (dead, needs-BVH, direction
    octant, origin Morton) before the walk and un-permutes the result
    afterwards (ops/sort.py). The permutation is estimator-invisible; it
    only changes which rays share a `lax.while_loop` trip. Off by default.
    """
    delta = p_to - p_from
    dist = jnp.sqrt(jnp.maximum(dot(delta, delta), 1e-20))
    d = delta / dist[:, None]
    tmin = jnp.full_like(dist, pack.ray_eps)
    tmax = dist - pack.ray_eps
    if mask is not None:
        tmin = jnp.where(mask, tmin, jnp.inf)
        tmax = jnp.where(mask, tmax, -1.0)
    o = p_from
    if sort:
        from ..ops import sort as sort_ops

        n = dist.shape[0]
        alive = tmax > 0.0
        key = sort_ops.shadow_sort_key(meta, pack, alive, o, d, tmin, tmax)
        # argsort + one packed gather: a variadic payload sort compiles
        # much more slowly, and the 2-operand argsort is shared program-wide
        perm = jnp.argsort(key)
        state = jnp.concatenate(
            [o, d, tmin[:, None], tmax[:, None]], axis=1)[perm]
        o, d = state[:, 0:3], state[:, 3:6]
        tmin, tmax = state[:, 6], state[:, 7]
        lane = perm
    hits, kinds = _kind_hits(meta, pack, o, d, tmin, tmax,
                             any_hit=True)
    if not hits:
        return jnp.zeros(dist.shape, bool)
    occ = hits[0].valid
    for h in hits[1:]:
        occ = occ | h.valid
    if sort:
        # unsort: row j holds original lane lane[j]; gather by argsort(lane)
        occ = occ[jnp.argsort(lane)]
    return occ


def emitted(pack: ScenePack, hit: Hit) -> jnp.ndarray:
    """Le at a hit point: one-sided area-light emission
    (reference: src/primitive.h:60-63, src/light.h:234-238)."""
    is_emitter = hit.light_id >= 0
    radiance = pack.light_c[jnp.maximum(hit.light_id, 0)]
    facing = dot(hit.normal, hit.wo) > 0.0
    return jnp.where(
        (is_emitter & facing & hit.valid)[:, None], radiance, 0.0
    )


def effective_kd(meta: SceneMeta, pack: ScenePack, hit: Hit, c0, tex_id):
    """Replace a material's Kd/base color with its texture tap when the
    material carries a texture id (the capability the reference's dead
    texture subsystem never delivers, SURVEY.md §2 #36). Texels stay on the
    autodiff tape. tex_id comes from gather_material."""
    if meta.n_tex == 0:
        return c0
    from ..ops import texture as tex_ops

    has = tex_id >= 0
    rgb = tex_ops.sample(pack, jnp.maximum(tex_id, 0), hit.uv, hit.position)
    return jnp.where(has[:, None], rgb, c0)


def light_is_delta(meta: SceneMeta, light_index: int) -> bool:
    """Static is_delta_light (reference: src/light.h:25-28)."""
    return meta.lights[light_index].kind in (LIGHT_POINT, LIGHT_DIRECTIONAL)


def gather_material(pack: ScenePack, mat_id):
    """Fetch material rows for a ray batch as
    (kind, c0, c1, s0, s1, remap, tex, mf)."""
    return (pack.mat_kind[mat_id], pack.mat_c0[mat_id], pack.mat_c1[mat_id],
            pack.mat_s0[mat_id], pack.mat_s1[mat_id],
            pack.mat_remap[mat_id], pack.mat_tex[mat_id],
            pack.mat_mf[mat_id])
