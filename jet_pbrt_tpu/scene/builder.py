"""Host-side scene construction -> packed device scene.

The Python-facing equivalent of FScene's Create* factory templates
(reference: src/scene.h:66-124) and convenience builders
(reference: src/scene.cc:49-97). Geometry/material/light rows accumulate in
numpy lists and `build()` packs them into a (SceneMeta, ScenePack) pair plus
a camera config; `Preprocess` (reference: src/scene.cc:11-23) corresponds to
the world-bound computation here plus the optional BVH build.

Note: the reference's CreateAreaLights has a bug — it registers the lights
but returns an empty vector (reference: src/scene.cc:79-89). Our
`add_area_light_mesh` registers one area light per triangle, which is what
the reference actually does internally.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..ops import bsdf as bsdf_ops
from ..ops.linalg import RAY_EPS_REL
from ..ops.sort import mesh_root_sphere
from .pack import (
    KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST,
    LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, LIGHT_ENV,
    LightMeta, SceneMeta, ScenePack,
)


@dataclasses.dataclass
class CameraConfig:
    lookfrom: tuple
    front: tuple
    vup: tuple
    vfov: float


@dataclasses.dataclass
class Scene:
    """A built scene: static meta + device arrays + camera config."""
    meta: SceneMeta
    pack: ScenePack
    camera: CameraConfig


class SceneBuilder:
    def __init__(self, name: str):
        self.name = name
        self.camera: CameraConfig | None = None
        # triangles are stored as vectorized blocks: dicts of
        # {p0,p1,p2,n,uv [K,...], mat int} + per-row light overrides, so a
        # 225k-triangle mesh ingests as one numpy block instead of 225k
        # Python rows
        self._tri_blocks = []
        self._tri_count = 0
        self._tri_lights = {}  # global tri index -> light id
        self._sph = []      # rows: (c, r, mat, light)
        self._rect = []     # rows: (q[4,3], n, mat, light)
        self._disk = []     # rows: (c, n, r, mat, light)
        self._mat = []      # rows: (kind, c0, c1, s0, s1, remap, tex, mf)
        self._lights = []   # rows: (LightMeta, c, pos, dir)
        self._tex = []      # rows: (kind, c0, c1, scale, image or None)
        # instanced mesh FAMILIES: each entry is a dict with the local-space
        # mesh + its instance rows (offset, scale, mat, light)
        self._inst_meshes = []

    # -- camera (reference: src/scene.h:67-73) ----------------------------
    def set_camera(self, lookfrom, lookat=None, front=None, vup=(0, 1, 0),
                   vfov=60.0):
        if front is None:
            front = np.asarray(lookat, np.float64) - np.asarray(lookfrom, np.float64)
        self.camera = CameraConfig(
            lookfrom=tuple(lookfrom), front=tuple(np.asarray(front, np.float64)),
            vup=tuple(vup), vfov=float(vfov),
        )

    # -- textures (wired in, unlike the reference's dead src/texture.h) ----
    def add_solid_texture(self, color) -> int:
        from ..ops import texture as T
        self._tex.append((T.TEX_SOLID, np.asarray(color, np.float32),
                          np.zeros(3, np.float32), 1.0, None))
        return len(self._tex) - 1

    def add_checker_texture(self, c0, c1, scale: float = 10.0) -> int:
        """3D sine checker (reference: src/texture.cc:26-35; default scale
        10 matches its hard-coded frequency)."""
        from ..ops import texture as T
        self._tex.append((T.TEX_CHECKER, np.asarray(c0, np.float32),
                          np.asarray(c1, np.float32), float(scale), None))
        return len(self._tex) - 1

    def add_image_texture(self, image, bilinear: bool = False) -> int:
        """image: [H,W,3] float in [0,1] or uint8 (scaled by 1/255 like the
        reference, src/texture.cc:70), or a file path (PNG/JPG via PIL,
        PPM via the built-in reader)."""
        from ..ops import texture as T
        if isinstance(image, str):
            if image.lower().endswith(".ppm"):
                from ..utils.image import read_ppm
                image = read_ppm(image)
            else:
                from PIL import Image
                image = np.asarray(Image.open(image).convert("RGB"))
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        kind = T.TEX_IMAGE_BILINEAR if bilinear else T.TEX_IMAGE
        self._tex.append((kind, np.zeros(3, np.float32),
                          np.zeros(3, np.float32), 1.0,
                          image.astype(np.float32)))
        return len(self._tex) - 1

    # -- materials (reference: src/material.h 5 concrete kinds) -----------
    def _add_mat(self, kind, c0, c1=(0, 0, 0), s0=0.0, s1=0.0, remap=False,
                 tex: int = -1, mf: int = 0) -> int:
        self._mat.append((kind, np.asarray(c0, np.float32),
                          np.asarray(c1, np.float32), float(s0), float(s1),
                          bool(remap), int(tex), int(mf)))
        return len(self._mat) - 1

    @staticmethod
    def _mf_kind(distribution: str) -> int:
        from ..ops import microfacet as mf_mod
        try:
            return {"ggx": mf_mod.GGX, "beckmann": mf_mod.BECKMANN}[distribution]
        except KeyError:
            raise ValueError(f"unknown microfacet distribution {distribution!r}")

    def add_matte(self, color, tex: int = -1) -> int:
        return self._add_mat(bsdf_ops.MAT_MATTE, color, tex=tex)

    def add_mirror(self, color) -> int:
        return self._add_mat(bsdf_ops.MAT_MIRROR, color)

    def add_glass(self, eta: float, kr=(1, 1, 1), kt=(1, 1, 1)) -> int:
        return self._add_mat(bsdf_ops.MAT_GLASS, kr, kt, eta)

    def add_plastic(self, kd, ks, roughness: float, remap: bool = False,
                    tex: int = -1, distribution: str = "ggx") -> int:
        return self._add_mat(bsdf_ops.MAT_PLASTIC, kd, ks, roughness,
                             roughness, remap, tex=tex,
                             mf=self._mf_kind(distribution))

    def add_metal(self, eta, k, urough: float, vrough: float,
                  remap: bool = False, distribution: str = "ggx") -> int:
        return self._add_mat(bsdf_ops.MAT_METAL, eta, k, urough, vrough,
                             remap, mf=self._mf_kind(distribution))

    def add_roughglass(self, eta: float, roughness: float, kr=(1, 1, 1),
                      kt=(1, 1, 1), remap: bool = False,
                      distribution: str = "ggx") -> int:
        """Rough dielectric from the reference's FMicrofacetReflection +
        FMicrofacetTransmission pair (the latter is orphaned in the
        reference, reference: src/bsdf.cc:80-145)."""
        return self._add_mat(bsdf_ops.MAT_ROUGHGLASS, kr, kt, roughness,
                             eta, remap, mf=self._mf_kind(distribution))

    def add_phong(self, ks, exponent: float) -> int:
        """Energy-conserving modified Phong specular reflection
        (reference: src/bsdf.h:555-631 FPhongSpecularReflection)."""
        return self._add_mat(bsdf_ops.MAT_PHONG, ks, s0=exponent)

    # -- shapes ------------------------------------------------------------
    def _add_tri_block(self, tris, mat: int, flip_normal: bool, uvs):
        """tris: [K,3,3]; uvs: [K,3,2] or None. Returns shape refs."""
        tris = np.asarray(tris, np.float32)
        k = len(tris)
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(norm > 0, n / np.maximum(norm, 1e-30),
                     np.array([0, 0, 1], np.float32))
        if flip_normal:
            n = -n
        if uvs is None:
            uvs = np.zeros((k, 3, 2), np.float32)
        self._tri_blocks.append(dict(
            p0=tris[:, 0], p1=tris[:, 1], p2=tris[:, 2],
            n=n.astype(np.float32), uv=np.asarray(uvs, np.float32), mat=mat,
        ))
        start = self._tri_count
        self._tri_count += k
        return [(KIND_TRI, start + i) for i in range(k)]

    def add_triangle(self, p0, p1, p2, mat: int, flip_normal=False, uv=None):
        tri = np.stack([np.asarray(p, np.float32) for p in (p0, p1, p2)])
        uvs = None if uv is None else np.asarray(uv, np.float32)[None]
        return self._add_tri_block(tri[None], mat, flip_normal, uvs)[0]

    def add_mesh(self, tris, mat: int, flip_normal=False,
                 flip_handedness=False, offset=(0, 0, 0), scale=1.0,
                 uvs=None):
        """tris: [T,3,3] vertex soup (+ optional uvs [T,3,2]). Transform
        order matches the loader: z-flip, then scale, then offset
        (reference: src/shape.cc:48-61)."""
        tris = np.asarray(tris, np.float32).copy()
        if flip_handedness:
            tris[..., 2] *= -1.0
        tris = tris * np.float32(scale) + np.asarray(offset, np.float32)
        return self._add_tri_block(tris, mat, flip_normal, uvs)

    def add_instanced_mesh(self, tris, instances, flip_normal=False,
                           flip_handedness=False, uvs=None):
        """Register one mesh FAMILY rendered as many instances sharing one
        BVH; call repeatedly for additional families (each gets its own
        shared BLAS — the reference instead re-loads and re-transforms the
        OBJ per copy, reference: src/main.cc:94-107, src/shape.cc:48-61).

        tris: [T,3,3] local-space vertex soup (+ optional uvs [T,3,2]);
        instances: iterable of (offset, scale, mat) or
        (offset, scale, mat, radiance). A 4-tuple makes that instance an
        EMISSIVE mesh: one area light over its whole surface (the batched
        equivalent of the reference's per-triangle FAreaLight loop,
        reference: src/scene.cc:79-89). Returns (mesh_index, instance ids).
        """
        tris = np.asarray(tris, np.float32).copy()
        if flip_handedness:
            tris[..., 2] *= -1.0
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = np.where(norm > 0, n / np.maximum(norm, 1e-30),
                     np.array([0, 0, 1], np.float32))
        if flip_normal:
            n = -n
        if uvs is None:
            uvs = np.zeros((len(tris), 3, 2), np.float32)
        mesh_idx = len(self._inst_meshes)
        rows = []
        ids = []
        for entry in instances:
            off, scale, mat = entry[:3]
            radiance = entry[3] if len(entry) > 3 else None
            assert float(scale) > 0.0, "instance scale must be positive"
            inst_id = len(rows)
            light_id = -1
            if radiance is not None:
                light_id = self._add_light(
                    LightMeta(LIGHT_AREA, shape_kind=KIND_INST + mesh_idx,
                              shape_idx=inst_id),
                    radiance,
                )
            rows.append((np.asarray(off, np.float32), float(scale),
                         int(mat), light_id))
            ids.append(inst_id)
        self._inst_meshes.append(dict(
            tris=tris, n=n.astype(np.float32),
            uv=np.asarray(uvs, np.float32), inst=rows,
        ))
        return mesh_idx, ids

    def add_sphere(self, center, radius: float, mat: int):
        self._sph.append([np.asarray(center, np.float32), float(radius), mat, -1])
        return (KIND_SPHERE, len(self._sph) - 1)

    def add_rect(self, q0, q1, q2, q3, mat: int, flip_normal=False):
        q = np.stack([np.asarray(p, np.float32) for p in (q0, q1, q2, q3)])
        n = np.cross(q[1] - q[0], q[2] - q[0])
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        self._rect.append([q, n.astype(np.float32), mat, -1])
        return (KIND_RECT, len(self._rect) - 1)

    def add_rect_xy(self, x0, x1, y0, y1, z, mat: int, flip_normal=False):
        """(reference: src/shape.cc:76-81)"""
        return self.add_rect((x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z),
                             mat, flip_normal)

    def add_rect_xz(self, x0, x1, z0, z1, y, mat: int, flip_normal=False):
        """(reference: src/shape.cc:83-88)"""
        return self.add_rect((x0, y, z0), (x0, y, z1), (x1, y, z1), (x1, y, z0),
                             mat, flip_normal)

    def add_rect_yz(self, y0, y1, z0, z1, x, mat: int, flip_normal=False):
        """(reference: src/shape.cc:90-95)"""
        return self.add_rect((x, y0, z0), (x, y1, z0), (x, y1, z1), (x, y0, z1),
                             mat, flip_normal)

    def add_disk(self, center, normal, radius: float, mat: int):
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._disk.append([np.asarray(center, np.float32), n, float(radius), mat, -1])
        return (KIND_DISK, len(self._disk) - 1)

    # -- lights ------------------------------------------------------------
    def _add_light(self, lm: LightMeta, c, pos=(0, 0, 0), direction=(0, 0, 1)) -> int:
        self._lights.append(
            (lm, np.asarray(c, np.float32), np.asarray(pos, np.float32),
             np.asarray(direction, np.float32))
        )
        return len(self._lights) - 1

    def add_point_light(self, pos, intensity) -> int:
        return self._add_light(LightMeta(LIGHT_POINT), intensity, pos=pos)

    def add_directional_light(self, direction, irradiance) -> int:
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        return self._add_light(LightMeta(LIGHT_DIRECTIONAL), irradiance, direction=d)

    def add_env_light(self, radiance) -> int:
        return self._add_light(LightMeta(LIGHT_ENV), radiance)

    def add_area_light(self, shape_ref, radiance) -> int:
        """Attach an area light to an existing shape
        (reference: src/scene.cc:66-77 CreateAreaLight)."""
        kind, idx = shape_ref
        light_id = self._add_light(
            LightMeta(LIGHT_AREA, shape_kind=kind, shape_idx=idx), radiance
        )
        if kind == KIND_TRI:
            self._tri_lights[idx] = light_id
        else:
            # (store, light-id column) per shape kind — see __init__ layouts
            store, col = {
                KIND_SPHERE: (self._sph, 3),
                KIND_RECT: (self._rect, 3),
                KIND_DISK: (self._disk, 4),
            }[kind]
            store[idx][col] = light_id
        return light_id

    def add_area_light_mesh(self, shape_refs, radiance) -> list:
        """One FAreaLight per shape (reference: src/scene.cc:79-89)."""
        return [self.add_area_light(r, radiance) for r in shape_refs]

    # -- build -------------------------------------------------------------
    def build(self, use_bvh: bool | None = None, bvh_leaf_size: int = 4,
              prune_black_nee: bool = True,
              ray_eps: float | None = None) -> Scene:
        def stack(rows, i, shape, dtype=np.float32):
            if rows:
                return np.stack([np.asarray(r[i], dtype) for r in rows])
            return np.zeros((0,) + shape, dtype)

        def cat(field, shape):
            if self._tri_blocks:
                return np.concatenate([b[field] for b in self._tri_blocks])
            return np.zeros((0,) + shape, np.float32)

        tri_p0 = cat("p0", (3,))
        tri_p1 = cat("p1", (3,))
        tri_p2 = cat("p2", (3,))
        tri_n = cat("n", (3,))
        tri_uv = cat("uv", (3, 2))
        tri_mat = np.concatenate(
            [np.full(len(b["p0"]), b["mat"], np.int32)
             for b in self._tri_blocks] or [np.zeros(0, np.int32)]
        )
        tri_light = np.full(self._tri_count, -1, np.int32)
        for gi, lid in self._tri_lights.items():
            tri_light[gi] = lid

        sph_c = stack(self._sph, 0, (3,))
        sph_r = np.array([r[1] for r in self._sph], np.float32)
        sph_mat = np.array([r[2] for r in self._sph], np.int32)
        sph_light = np.array([r[3] for r in self._sph], np.int32)

        rect_q = stack(self._rect, 0, (4, 3))
        rect_n = stack(self._rect, 1, (3,))
        rect_mat = np.array([r[2] for r in self._rect], np.int32)
        rect_light = np.array([r[3] for r in self._rect], np.int32)

        disk_c = stack(self._disk, 0, (3,))
        disk_n = stack(self._disk, 1, (3,))
        disk_r = np.array([r[2] for r in self._disk], np.float32)
        disk_mat = np.array([r[3] for r in self._disk], np.int32)
        disk_light = np.array([r[4] for r in self._disk], np.int32)

        mat_kind = np.array([m[0] for m in self._mat], np.int32)
        mat_c0 = stack(self._mat, 1, (3,))
        mat_c1 = stack(self._mat, 2, (3,))
        mat_s0 = np.array([m[3] for m in self._mat], np.float32)
        mat_s1 = np.array([m[4] for m in self._mat], np.float32)
        mat_remap = np.array([m[5] for m in self._mat], bool)
        mat_tex = np.array([m[6] for m in self._mat], np.int32)
        mat_mf = np.array([m[7] for m in self._mat], np.int32)

        # texture table: images padded to the max resolution
        n_tex = len(self._tex)
        tex_kind = np.array([t[0] for t in self._tex], np.int32)
        tex_c0 = stack(self._tex, 1, (3,))
        tex_c1 = stack(self._tex, 2, (3,))
        tex_scale = np.array([t[3] for t in self._tex], np.float32)
        images = [t[4] for t in self._tex]
        th = max([im.shape[0] for im in images if im is not None] or [1])
        tw = max([im.shape[1] for im in images if im is not None] or [1])
        tex_image = np.zeros((n_tex, th, tw, 3), np.float32)
        tex_wh = np.ones((n_tex, 2), np.int32)
        for i, im in enumerate(images):
            if im is not None:
                tex_image[i, : im.shape[0], : im.shape[1]] = im
                tex_wh[i] = (im.shape[1], im.shape[0])

        n_lights = len(self._lights)
        light_c = stack(self._lights, 1, (3,))
        light_pos = stack(self._lights, 2, (3,))
        light_dir = stack(self._lights, 3, (3,))

        # world bounding sphere (reference: src/scene.cc:35-45 + geometry.h:307-311)
        pts = [tri_p0, tri_p1, tri_p2, rect_q.reshape(-1, 3), disk_c]
        if len(sph_c):
            pts += [sph_c - sph_r[:, None], sph_c + sph_r[:, None]]
        for fam in self._inst_meshes:
            mesh_lo = fam["tris"].reshape(-1, 3).min(0)
            mesh_hi = fam["tris"].reshape(-1, 3).max(0)
            for off, scale, _m, _l in fam["inst"]:
                pts.append(np.stack([mesh_lo * scale + off,
                                     mesh_hi * scale + off]))
        allpts = np.concatenate([p for p in pts if len(p)] or [np.zeros((1, 3), np.float32)])
        bmin, bmax = allpts.min(0), allpts.max(0)
        center = 0.5 * (bmin + bmax)
        radius = float(np.linalg.norm(bmax - center))

        n_tri = self._tri_count
        if use_bvh is None:
            use_bvh = n_tri > 64

        if use_bvh and n_tri:
            from ..ops.bvh import build_bvh
            bvh, order = build_bvh(
                tri_p0, tri_p1, tri_p2, leaf_size=bvh_leaf_size
            )
            tri_p0, tri_p1, tri_p2 = tri_p0[order], tri_p1[order], tri_p2[order]
            tri_n, tri_mat, tri_light = tri_n[order], tri_mat[order], tri_light[order]
            tri_uv = tri_uv[order]
            # remap area-light shape indices that point at triangles
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            new_lights = []
            for lm, c, p, d in self._lights:
                if lm.kind == LIGHT_AREA and lm.shape_kind == KIND_TRI:
                    lm = LightMeta(LIGHT_AREA, KIND_TRI, int(inv[lm.shape_idx]))
                new_lights.append((lm, c, p, d))
            self._lights = new_lights
            from ..ops.bvh import pack_node_table
            bvh_nodes = pack_node_table(bvh, len(order), bvh_leaf_size)
            bvh_tris = np.concatenate(
                [tri_p0, tri_p1 - tri_p0, tri_p2 - tri_p0], axis=1
            ).astype(np.float32)
        else:
            use_bvh = False
            bvh_nodes = np.zeros((0, 8), np.float32)
            bvh_tris = np.zeros((0, 9), np.float32)

        # ---- instanced mesh families: per-family shared BLAS + instance
        # table + TLAS (each family is an independent two-level structure)
        fam_tabs = []   # per family: dict of numpy tables
        inst_newpos = []  # per family: old->new instance position map
        for m in self._inst_meshes:
            from ..ops.bvh import build_bvh, build_box_bvh, pack_node_table
            rows = m["inst"]
            f_off = np.stack([r[0] for r in rows])
            f_scale = np.array([r[1] for r in rows], np.float32)
            f_mat = np.array([r[2] for r in rows], np.int32)
            f_light = np.array([r[3] for r in rows], np.int32)
            t0, t1, t2 = m["tris"][:, 0], m["tris"][:, 1], m["tris"][:, 2]
            blas, border = build_bvh(t0, t1, t2, leaf_size=bvh_leaf_size)
            t0, t1, t2 = t0[border], t1[border], t2[border]
            f_blas_nodes = pack_node_table(blas, len(border), bvh_leaf_size)
            f_blas_tris = np.concatenate(
                [t0, t1 - t0, t2 - t0], axis=1
            ).astype(np.float32)
            # TLAS over instance world AABBs (root box = BLAS root scaled +
            # offset), one instance per leaf: leaf code = instance * 8 + 1
            root_lo, root_hi = f_blas_nodes[0, :3], f_blas_nodes[0, 3:6]
            ib_lo = root_lo[None] * f_scale[:, None] + f_off
            ib_hi = root_hi[None] * f_scale[:, None] + f_off
            tlas, torder = build_box_bvh(ib_lo, ib_hi, leaf_size=1)
            f_off, f_scale = f_off[torder], f_scale[torder]
            f_mat, f_light = f_mat[torder], f_light[torder]
            # instance rows were permuted: emissive-instance lights carry
            # the instance id in shape_idx and must follow
            newpos = np.empty(len(torder), np.int64)
            newpos[np.asarray(torder)] = np.arange(len(torder))
            inst_newpos.append(newpos)
            # raw (unpadded, unordered) mesh table for emissive-instance
            # light sampling — blas_tris pads leaves by DUPLICATING tris
            t0r = m["tris"][:, 0]
            em_tris = np.concatenate(
                [t0r, m["tris"][:, 1] - t0r, m["tris"][:, 2] - t0r], axis=1
            ).astype(np.float32) if (f_light >= 0).any() else np.zeros(
                (0, 9), np.float32)
            em_n = (m["n"].astype(np.float32) if (f_light >= 0).any()
                    else np.zeros((0, 3), np.float32))
            fam_tabs.append(dict(
                off=f_off, scale=f_scale, mat=f_mat, light=f_light,
                blas_nodes=f_blas_nodes, blas_tris=f_blas_tris,
                blas_n=m["n"][border], blas_uv=m["uv"][border],
                tlas_nodes=pack_node_table(tlas, len(torder), 1),
                em_tris=em_tris, em_n=em_n,
                root=mesh_root_sphere(f_blas_tris),
            ))

        lobe_map = {
            bsdf_ops.MAT_MATTE: (bsdf_ops.LOBE_LAMBERT,),
            bsdf_ops.MAT_MIRROR: (bsdf_ops.LOBE_SPECULAR,),
            bsdf_ops.MAT_GLASS: (bsdf_ops.LOBE_FRESNEL,),
            bsdf_ops.MAT_PLASTIC: (bsdf_ops.LOBE_LAMBERT,
                                   bsdf_ops.LOBE_MICROFACET),
            bsdf_ops.MAT_METAL: (bsdf_ops.LOBE_MICROFACET,),
            bsdf_ops.MAT_ROUGHGLASS: (bsdf_ops.LOBE_MICROFACET,
                                      bsdf_ops.LOBE_MICROFACET_TRANS),
            bsdf_ops.MAT_PHONG: (bsdf_ops.LOBE_PHONG,),
        }
        present_lobes = tuple(sorted({
            lb for m in self._mat for lb in lobe_map[m[0]]
        }))
        # microfacet distribution kinds actually reachable (materials that
        # resolve to a microfacet lobe)
        mf_mats = {bsdf_ops.MAT_PLASTIC, bsdf_ops.MAT_METAL,
                   bsdf_ops.MAT_ROUGHGLASS}
        present_mf_kinds = tuple(sorted({
            m[7] for m in self._mat if m[0] in mf_mats
        }))

        light_metas = []
        for lm, c, _pos, _dir in self._lights:
            if prune_black_nee and float(np.abs(c).sum()) == 0.0:
                lm = dataclasses.replace(lm, static_black=True)
            if lm.kind == LIGHT_AREA and lm.shape_kind >= KIND_INST:
                mi = lm.shape_kind - KIND_INST
                lm = dataclasses.replace(
                    lm, shape_idx=int(inst_newpos[mi][lm.shape_idx]))
            light_metas.append(lm)
        meta = SceneMeta(
            name=self.name,
            n_tri=n_tri,
            n_sph=len(self._sph),
            n_rect=len(self._rect),
            n_disk=len(self._disk),
            n_mat=len(self._mat),
            lights=tuple(light_metas),
            use_bvh=bool(use_bvh),
            n_tex=n_tex,
            present_lobes=present_lobes,
            present_mf_kinds=present_mf_kinds,
            n_inst=tuple(len(f["scale"]) for f in fam_tabs),
            n_blas_tris=tuple(int(f["blas_tris"].shape[0])
                              for f in fam_tabs),
            bvh_leaf_size=bvh_leaf_size,
        )
        pack = ScenePack(
            tri_p0=jnp.asarray(tri_p0), tri_p1=jnp.asarray(tri_p1),
            tri_p2=jnp.asarray(tri_p2), tri_n=jnp.asarray(tri_n),
            tri_uv=jnp.asarray(tri_uv),
            tri_mat=jnp.asarray(tri_mat), tri_light=jnp.asarray(tri_light),
            sph_c=jnp.asarray(sph_c), sph_r=jnp.asarray(sph_r),
            sph_mat=jnp.asarray(sph_mat), sph_light=jnp.asarray(sph_light),
            rect_q=jnp.asarray(rect_q), rect_n=jnp.asarray(rect_n),
            rect_mat=jnp.asarray(rect_mat), rect_light=jnp.asarray(rect_light),
            disk_c=jnp.asarray(disk_c), disk_n=jnp.asarray(disk_n),
            disk_r=jnp.asarray(disk_r), disk_mat=jnp.asarray(disk_mat),
            disk_light=jnp.asarray(disk_light),
            mat_kind=jnp.asarray(mat_kind), mat_c0=jnp.asarray(mat_c0),
            mat_c1=jnp.asarray(mat_c1), mat_s0=jnp.asarray(mat_s0),
            mat_s1=jnp.asarray(mat_s1), mat_remap=jnp.asarray(mat_remap),
            mat_tex=jnp.asarray(mat_tex), mat_mf=jnp.asarray(mat_mf),
            tex_kind=jnp.asarray(tex_kind), tex_c0=jnp.asarray(tex_c0),
            tex_c1=jnp.asarray(tex_c1), tex_scale=jnp.asarray(tex_scale),
            tex_image=jnp.asarray(tex_image), tex_wh=jnp.asarray(tex_wh),
            light_c=jnp.asarray(light_c), light_pos=jnp.asarray(light_pos),
            light_dir=jnp.asarray(light_dir),
            world_center=jnp.asarray(center, jnp.float32),
            world_radius=jnp.asarray(radius, jnp.float32),
            # spawn/shadow epsilon: scale-relative unless pinned
            # (reference-faithful mode passes ray_eps=1e-3 explicitly)
            ray_eps=jnp.asarray(
                ray_eps if ray_eps is not None
                else max(float(2.0 * radius) * RAY_EPS_REL, 1e-30),
                jnp.float32),
            bvh_nodes=jnp.asarray(bvh_nodes), bvh_tris=jnp.asarray(bvh_tris),
            bvh_root=jnp.asarray(mesh_root_sphere(bvh_tris)),
            blas_nodes=tuple(jnp.asarray(f["blas_nodes"])
                             for f in fam_tabs),
            blas_tris=tuple(jnp.asarray(f["blas_tris"]) for f in fam_tabs),
            blas_n=tuple(jnp.asarray(f["blas_n"]) for f in fam_tabs),
            blas_uv=tuple(jnp.asarray(f["blas_uv"]) for f in fam_tabs),
            inst_off=tuple(jnp.asarray(f["off"]) for f in fam_tabs),
            inst_scale=tuple(jnp.asarray(f["scale"]) for f in fam_tabs),
            inst_mat=tuple(jnp.asarray(f["mat"]) for f in fam_tabs),
            inst_light=tuple(jnp.asarray(f["light"]) for f in fam_tabs),
            tlas_nodes=tuple(jnp.asarray(f["tlas_nodes"])
                             for f in fam_tabs),
            inst_root=tuple(jnp.asarray(f["root"]) for f in fam_tabs),
            inst_em_tris=tuple(jnp.asarray(f["em_tris"])
                               for f in fam_tabs),
            inst_em_n=tuple(jnp.asarray(f["em_n"]) for f in fam_tabs),
        )
        assert self.camera is not None, "scene needs a camera"
        return Scene(meta=meta, pack=pack, camera=self.camera)
