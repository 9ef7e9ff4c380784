"""Light sampling: point / directional / area (tri, rect, disk, sphere) /
constant environment.

Batched equivalent of the FLight hierarchy (reference: src/light.h:50-311)
and the FShape light-sampling API (reference: src/shape.h:120-181, 549-656).
Light *kinds* are static (SceneMeta.lights), so NEE dispatches with ordinary
Python control flow at trace time — no lax.switch — while light *parameters*
(radiance/intensity) come from ScenePack arrays and stay differentiable.

Documented divergence: the reference's inside-an-emissive-sphere sampling
branch converts the area pdf with the *shading point's* normal
(reference: src/shape.h:579) where pbrt-v3 and the base-class path
(reference: src/shape.h:138) use the light-point normal; we use the light
normal (the correct measure conversion).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .linalg import (
    PI,
    dot,
    normalize,
    distance2,
    frame_from_z,
    to_world,
)
from .sampling import (
    sample_uniform_sphere,
    sample_uniform_triangle,
    sample_concentric_disk,
    pdf_uniform_cone,
)


class LightSample(NamedTuple):
    """Batched FLightSample (reference: src/light.h:31-45)."""
    wi: jnp.ndarray   # [N,3] world
    pdf: jnp.ndarray  # [N] solid-angle pdf
    li: jnp.ndarray   # [N,3]
    pos: jnp.ndarray  # [N,3] point on light


def _area_convert_pdf(pdf_area, light_pos, light_n, shade_pos, wi):
    """Area -> solid-angle pdf: x dist^2 / |cos| at the light
    (reference: src/shape.h:124-145); non-finite -> 0."""
    d2 = distance2(light_pos, shade_pos)
    cos_l = jnp.abs(dot(light_n, -wi))
    pdf = pdf_area * d2 / jnp.maximum(cos_l, 1e-12)
    pdf = jnp.where((d2 > 0.0) & (cos_l > 1e-9) & jnp.isfinite(pdf), pdf, 0.0)
    return pdf


def _sample_shape_position(pack, shape_kind, shape_idx, u):
    """SamplePosition for one static shape row -> (pos [N,3], n [N,3],
    pdf_area [N]). Mirrors the per-shape SamplePosition methods
    (reference: src/shape.h:256-268, 353-363, 459-467, 549-561)."""
    from ..scene.pack import (
        KIND_TRI, KIND_SPHERE, KIND_RECT, KIND_DISK, KIND_INST,
    )

    n_batch = u.shape[0]
    if shape_kind == KIND_TRI:
        p0 = pack.tri_p0[shape_idx]
        p1 = pack.tri_p1[shape_idx]
        p2 = pack.tri_p2[shape_idx]
        b = sample_uniform_triangle(u)
        pos = (
            b[:, 0:1] * p0[None, :]
            + b[:, 1:2] * p1[None, :]
            + (1.0 - b[:, 0:1] - b[:, 1:2]) * p2[None, :]
        )
        nrm = jnp.broadcast_to(pack.tri_n[shape_idx][None, :], (n_batch, 3))
        area = 0.5 * jnp.linalg.norm(jnp.cross(p1 - p0, p2 - p0))
    elif shape_kind == KIND_RECT:
        q = pack.rect_q[shape_idx]  # [4,3]
        # pos = p1 + (p0-p1) u + (p2-p1) v (reference: src/shape.h:462)
        pos = (
            q[1][None, :]
            + u[:, 0:1] * (q[0] - q[1])[None, :]
            + u[:, 1:2] * (q[2] - q[1])[None, :]
        )
        nrm = jnp.broadcast_to(pack.rect_n[shape_idx][None, :], (n_batch, 3))
        area = jnp.linalg.norm(jnp.cross(q[0] - q[1], q[2] - q[1]))
    elif shape_kind == KIND_DISK:
        c = pack.disk_c[shape_idx]
        nd = pack.disk_n[shape_idx]
        r = pack.disk_r[shape_idx]
        s, t, _ = frame_from_z(nd[None, :])
        dpt = sample_concentric_disk(u)
        pos = c[None, :] + r * (s * dpt[:, 0:1] + t * dpt[:, 1:2])
        nrm = jnp.broadcast_to(nd[None, :], (n_batch, 3))
        area = PI * r * r
    elif shape_kind == KIND_SPHERE:
        c = pack.sph_c[shape_idx]
        r = pack.sph_r[shape_idx]
        dirs = sample_uniform_sphere(u)
        pos = c[None, :] + r * dirs
        nrm = dirs
        area = 4.0 * PI * r * r
    elif shape_kind >= KIND_INST:
        # emissive INSTANCE: sample a triangle of the shared BLAS uniformly
        # (index, not area-weighted — the remapped u would need a CDF
        # search per lane; per-sample pdf carries the exact per-triangle
        # area so the estimator stays unbiased), then a uniform barycentric
        # point, transformed by the instance (uniform scale + translation).
        # The reference instead attaches one FAreaLight per triangle and
        # NEE-loops over all of them (reference: src/scene.cc:79-89); one
        # instance-level light with per-triangle pdf is the batched
        # equivalent.

        # sample from the RAW mesh table (blas_tris pads leaves by
        # duplicating triangles, which would double-cover their area)
        mi = shape_kind - KIND_INST
        t_count = pack.inst_em_tris[mi].shape[0]
        off = pack.inst_off[mi][shape_idx]
        scl = pack.inst_scale[mi][shape_idx]
        u0 = jnp.clip(u[:, 0] * t_count, 0.0, t_count - 1e-3)
        ti = u0.astype(jnp.int32)
        u0r = u0 - ti.astype(jnp.float32)   # remapped leftover uniform
        rows = pack.inst_em_tris[mi][ti]
        p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        b = sample_uniform_triangle(
            jnp.stack([u0r, u[:, 1]], axis=-1))
        # b = (b0, b1) weights on (p0, p1); p = p0 + (1-b0-?) ... express
        # via edges: p_local = p0 + (b1) e1 + (1 - b0 - b1) e2 with the
        # same convention as the KIND_TRI branch above
        pos_l = p0 + b[:, 1:2] * e1 + (1.0 - b[:, 0:1] - b[:, 1:2]) * e2
        pos = pos_l * scl + off[None, :]
        nrm = pack.inst_em_n[mi][ti]
        area_l = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
        area_w = jnp.maximum(area_l * scl * scl, 1e-20)
        return pos, nrm, 1.0 / (t_count * area_w)
    else:
        raise ValueError(f"bad shape kind {shape_kind}")
    pdf_area = jnp.full((n_batch,), 1.0, jnp.float32) / area
    return pos, nrm, pdf_area


def _sample_sphere_cone(pack, shape_idx, shade_pos, u):
    """Cone sampling toward a sphere when outside it
    (reference: src/shape.h:564-644), with the Taylor small-cone fallback.
    Returns (pos, n, pdf_solidangle, inside_mask_fallback...)."""
    c = pack.sph_c[shape_idx]
    r = pack.sph_r[shape_idx]
    delta = c[None, :] - shade_pos
    dist2 = jnp.maximum(dot(delta, delta), 1e-20)
    dist = jnp.sqrt(dist2)
    inv_dist = 1.0 / dist
    w = delta * inv_dist[:, None]

    sin2_max = jnp.clip(r * r / dist2, 0.0, 1.0)
    sin_max = jnp.sqrt(sin2_max)
    inv_sin_max = 1.0 / jnp.maximum(sin_max, 1e-12)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))

    cos_t = (cos_max - 1.0) * u[:, 0] + 1.0
    sin2_t = 1.0 - cos_t * cos_t
    # Taylor fallback for tiny cones (reference: src/shape.h:613-619)
    small = sin2_max < 0.00068523
    sin2_t = jnp.where(small, sin2_max * u[:, 0], sin2_t)
    cos_t = jnp.where(small, jnp.sqrt(1.0 - sin2_t), cos_t)

    cos_alpha = sin2_t * inv_sin_max + cos_t * jnp.sqrt(
        jnp.maximum(0.0, 1.0 - sin2_t * inv_sin_max * inv_sin_max)
    )
    sin_alpha = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_alpha * cos_alpha))
    phi = u[:, 1] * 2.0 * PI

    frame = frame_from_z(w)
    local = jnp.stack(
        [sin_alpha * jnp.cos(phi), sin_alpha * jnp.sin(phi), cos_alpha], axis=-1
    )
    world_normal = -to_world(frame, local)
    pos = c[None, :] + r * world_normal
    pdf = pdf_uniform_cone(cos_max)
    return pos, world_normal, pdf, dist2, r


def sample_area_light(pack, light_index: int, shape_kind: int, shape_idx: int,
                      shade_pos, u) -> LightSample:
    """FAreaLight::Sample_Li (reference: src/light.h:199-216) for one static
    light row."""
    radiance = pack.light_c[light_index]

    if shape_kind == 1:  # KIND_SPHERE: cone/area hybrid
        pos_cone, n_cone, pdf_cone, dist2, r = _sample_sphere_cone(
            pack, shape_idx, shade_pos, u
        )
        pos_area, n_area, pdf_a = _sample_shape_position(pack, shape_kind, shape_idx, u)
        inside = dist2 <= (r * r)
        wi_area = normalize(pos_area - shade_pos)
        pdf_area_sa = _area_convert_pdf(pdf_a, pos_area, n_area, shade_pos, wi_area)
        pos = jnp.where(inside[:, None], pos_area, pos_cone)
        nrm = jnp.where(inside[:, None], n_area, n_cone)
        pdf = jnp.where(inside, pdf_area_sa, pdf_cone)
    else:
        pos, nrm, pdf_a = _sample_shape_position(pack, shape_kind, shape_idx, u)
        wi0 = normalize(pos - shade_pos)
        pdf = _area_convert_pdf(pdf_a, pos, nrm, shade_pos, wi0)

    wi = normalize(pos - shade_pos)
    # one-sided emission (reference: src/light.h:234-238)
    facing = dot(nrm, -wi) > 0.0
    d2 = distance2(pos, shade_pos)
    li = jnp.where(
        (facing & (pdf > 0.0) & (d2 > 0.0))[:, None], radiance[None, :], 0.0
    )
    return LightSample(wi=wi, pdf=pdf, li=li, pos=pos)


def sample_li(meta, pack, light_index: int, shade_pos, u) -> LightSample:
    """Sample_Li for static light `light_index` over a shading batch.

    u: [N,2] uniforms from the NEE stream.
    """
    from ..scene.pack import LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_AREA, LIGHT_ENV

    lm = meta.lights[light_index]
    n = shade_pos.shape[0]

    if lm.kind == LIGHT_POINT:
        # Li = I/d^2, pdf = 1 (reference: src/light.h:94-123)
        lpos = pack.light_pos[light_index]
        delta = lpos[None, :] - shade_pos
        d2 = jnp.maximum(dot(delta, delta), 1e-20)
        wi = delta / jnp.sqrt(d2)[:, None]
        li = pack.light_c[light_index][None, :] / d2[:, None]
        return LightSample(
            wi=wi, pdf=jnp.ones((n,), jnp.float32), li=li,
            pos=jnp.broadcast_to(lpos[None, :], (n, 3)),
        )

    if lm.kind == LIGHT_DIRECTIONAL:
        # (reference: src/light.h:155-164)
        wi = jnp.broadcast_to(-pack.light_dir[light_index][None, :], (n, 3))
        pos = shade_pos + wi * (2.0 * pack.world_radius)
        li = jnp.broadcast_to(pack.light_c[light_index][None, :], (n, 3))
        return LightSample(wi=wi, pdf=jnp.ones((n,), jnp.float32), li=li, pos=pos)

    if lm.kind == LIGHT_AREA:
        return sample_area_light(
            pack, light_index, lm.shape_kind, lm.shape_idx, shade_pos, u
        )

    if lm.kind == LIGHT_ENV:
        # lat-long direction sampling (reference: src/light.h:265-287)
        theta = u[:, 1] * PI
        phi = u[:, 0] * 2.0 * PI
        sin_t = jnp.sin(theta)
        wi = jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)], axis=-1
        )
        pos = shade_pos + wi * (2.0 * pack.world_radius)
        pdf = jnp.where(sin_t != 0.0, 1.0 / (2.0 * PI * PI * jnp.maximum(sin_t, 1e-12)), 0.0)
        li = jnp.broadcast_to(pack.light_c[light_index][None, :], (n, 3))
        return LightSample(wi=wi, pdf=pdf, li=li, pos=pos)

    raise ValueError(f"bad light kind {lm.kind}")


def env_radiance(meta, pack, n: int) -> jnp.ndarray:
    """Sum of constant-environment Le for escaped rays
    (reference: src/light.h:300-303, src/integrator.cc:333-336)."""
    le = jnp.zeros((n, 3), jnp.float32)
    for i in meta.env_light_indices:
        le = le + pack.light_c[i][None, :]
    return le


def pdf_li(meta, pack, light_index: int, shade_pos, wi) -> jnp.ndarray:
    """Pdf_Li for MIS (reference: src/light.h:218-221, 289-298,
    src/shape.h:147-181, 646-656). Delta lights return 0."""
    from ..scene.pack import LIGHT_AREA, LIGHT_ENV, KIND_SPHERE
    from ..scene.pack import KIND_TRI, KIND_RECT, KIND_DISK
    from . import intersect as isect_ops

    lm = meta.lights[light_index]
    n = shade_pos.shape[0]

    if lm.kind == LIGHT_ENV:
        cos_theta = jnp.clip(wi[:, 2], -1.0, 1.0)
        sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
        return jnp.where(
            sin_theta > 0.0, 1.0 / (2.0 * PI * PI * jnp.maximum(sin_theta, 1e-12)), 0.0
        )

    if lm.kind != LIGHT_AREA:
        return jnp.zeros((n,), jnp.float32)

    sk, si = lm.shape_kind, lm.shape_idx
    from ..scene.pack import KIND_INST
    if sk >= KIND_INST:
        # Emissive INSTANCE: Pdf_Li semantics follow the reference's
        # re-intersect-then-convert scheme (reference: src/light.h:224-244
        # -> src/shape.h:147-181) generalized to the per-triangle sampler of
        # _sample_shape_position: re-intersect THIS instance's mesh alone
        # (the reference's Pdf_Direction also re-intersects only the light's
        # own shape), and at the hit triangle k the area pdf is
        # 1/(t_count * area_k), so pdf_sa = d^2 / (cos * t_count * area_k).
        mi = sk - KIND_INST
        t_count = pack.inst_em_tris[mi].shape[0]
        # re-intersect against the RAW emissive mesh table (unpadded — the
        # traversal tables duplicate triangles for leaf padding, which
        # would corrupt the area pdf). Brute-force is the right tool:
        # emissive instances are light meshes. Guard the blow-up case
        # loudly.
        assert t_count <= 8192, (
            "pdf_li over an emissive instance brute-forces the raw mesh; "
            f"{t_count} triangles is beyond the supported light-mesh size")
        off = pack.inst_off[mi][si]
        scl = pack.inst_scale[mi][si]
        inv = 1.0 / scl
        o_l = (shade_pos - off[None, :]) * inv
        tmin_l = jnp.full((n,), 1e-3, jnp.float32) * inv
        tmax_l = jnp.full((n,), jnp.inf, jnp.float32)
        em = pack.inst_em_tris[mi]
        p0 = em[:, 0:3]
        from . import intersect as isect
        h = isect.intersect_triangles(
            o_l, wi, tmin_l, tmax_l, p0, p0 + em[:, 3:6], p0 + em[:, 6:9])
        ti = jnp.clip(h.index, 0, t_count - 1)
        rows = em[ti]
        e1, e2 = rows[:, 3:6], rows[:, 6:9]
        ln = pack.inst_em_n[mi][ti]
        area_w = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1) * scl * scl
        t_w = jnp.where(h.valid, h.t, 1.0) * scl
        lp = shade_pos + t_w[:, None] * wi
        pdf = distance2(shade_pos, lp) / jnp.maximum(
            jnp.abs(dot(ln, -wi)) * t_count * area_w, 1e-12)
        return jnp.where(h.valid & jnp.isfinite(pdf), pdf, 0.0)
    tmin = jnp.full((n,), 1e-3, jnp.float32)
    tmax = jnp.full((n,), jnp.inf, jnp.float32)

    if sk == KIND_SPHERE:
        c = pack.sph_c[si]
        r = pack.sph_r[si]
        d2 = distance2(shade_pos, c[None, :])
        sin2_max = jnp.clip(r * r / jnp.maximum(d2, 1e-20), 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))
        pdf_out = pdf_uniform_cone(cos_max)
        # inside: fall through to re-intersection pdf below
        h = isect_ops.intersect_spheres(
            shade_pos, wi, tmin, tmax, pack.sph_c[si : si + 1], pack.sph_r[si : si + 1]
        )
        t_safe = jnp.where(h.valid, h.t, 1.0)
        lp = shade_pos + t_safe[:, None] * wi
        ln = normalize(lp - c[None, :])
        area = 4.0 * PI * r * r
        pdf_in = jnp.where(
            h.valid,
            distance2(shade_pos, lp)
            / jnp.maximum(jnp.abs(dot(ln, -wi)) * area, 1e-12),
            0.0,
        )
        return jnp.where(d2 <= r * r, pdf_in, pdf_out)

    # tri / rect / disk: re-intersect then dist^2/(cos * area)
    if sk == KIND_TRI:
        h = isect_ops.intersect_triangles(
            shade_pos, wi, tmin, tmax,
            pack.tri_p0[si : si + 1], pack.tri_p1[si : si + 1], pack.tri_p2[si : si + 1],
        )
        ln = jnp.broadcast_to(pack.tri_n[si][None, :], (n, 3))
        p0, p1, p2 = pack.tri_p0[si], pack.tri_p1[si], pack.tri_p2[si]
        area = 0.5 * jnp.linalg.norm(jnp.cross(p1 - p0, p2 - p0))
    elif sk == KIND_RECT:
        q = pack.rect_q[si]
        h = isect_ops.intersect_rects(
            shade_pos, wi, tmin, tmax,
            q[None, 0], q[None, 1], q[None, 2], q[None, 3], pack.rect_n[si : si + 1],
        )
        ln = jnp.broadcast_to(pack.rect_n[si][None, :], (n, 3))
        area = jnp.linalg.norm(jnp.cross(q[0] - q[1], q[2] - q[1]))
    elif sk == KIND_DISK:
        h = isect_ops.intersect_disks(
            shade_pos, wi, tmin, tmax,
            pack.disk_c[si : si + 1], pack.disk_n[si : si + 1], pack.disk_r[si : si + 1],
        )
        ln = jnp.broadcast_to(pack.disk_n[si][None, :], (n, 3))
        r = pack.disk_r[si]
        area = PI * r * r
    else:
        raise ValueError(f"bad area-light shape kind {sk}")

    t_safe = jnp.where(h.valid, h.t, 1.0)
    lp = shade_pos + t_safe[:, None] * wi
    pdf = distance2(shade_pos, lp) / jnp.maximum(
        jnp.abs(dot(ln, -wi)) * area, 1e-12
    )
    return jnp.where(h.valid & jnp.isfinite(pdf), pdf, 0.0)
