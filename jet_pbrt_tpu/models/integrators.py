"""Light-transport integrators as batched megakernels.

Batched re-design of the reference integrator family
(reference: src/integrator.h:27-122, src/integrator.cc). The reference
traces one ray at a time through virtual calls; here a whole wave of paths
advances in lockstep through a statically-unrolled bounce loop with per-lane
active masks — the masked-megakernel architecture (wavefront compaction is a
possible later refinement; see PAPERS.md megakernel-vs-wavefront).

`li_path` reproduces the estimator of FPathIntegratorIteration::Li exactly
(reference: src/integrator.cc:316-403):
  * emission only at bounce 0 or after a specular bounce (no MIS),
  * NEE over every scene light for non-delta BSDFs,
  * russian roulette from bounce 3 with q = max(0.05, 1 - maxcomp(f)) — note
    the reference uses the *sampled f*, not throughput, and we match it,
  * termination at max_depth.
An optional power-heuristic MIS mode (`mis=True`) is the documented upgrade
the reference defines but never wires in (reference: src/sampling.h:128-137).

Differentiability: sampled directions, pdfs, and RR decisions are
stop-gradiented (detached sampling); radiance weights (f, Li, emission)
stay on the tape, making the estimate differentiable w.r.t. material and
emission parameters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops import rng
from ..ops.linalg import (
    absdot,
    dot,
    frame_from_z,
    to_local,
    to_world,
    max_component,
    is_black,
    RAY_EPS,
)
from ..ops import sort as sort_ops
from ..ops.sampling import power_heuristic
from ..scene import pack as scene_pack

_sg = jax.lax.stop_gradient


def li_path(meta, pack, o, d, u, max_depth: int, mis: bool = False,
            nee: bool = True, with_stats: bool = False,
            sort_rays: bool = False):
    """Iterative path-traced radiance for a ray batch.

    o, d: [N,3] primary rays; u: per-lane PRNG keys [N] or pregenerated
    uniforms [N, max_depth+1, S] (see ops/rng.py). Returns L [N,3].

    nee=False disables next-event estimation and credits emission at every
    bounce — the plain BSDF-sampling estimator of the same integral. It is
    used by tests as an independent cross-check of the NEE estimator
    (both must converge to the same image).

    sort_rays permutes lanes between bounces — dead lanes to the tail,
    live lanes by (origin Morton, direction octant) — and the shadow
    batches of the first two bounces likewise (ops/sort.py). The estimate
    is identical either way; it is purely a traversal-throughput knob, and
    it is off by default.
    """
    n = o.shape[0]
    nl = meta.n_lights
    L = jnp.zeros((n, 3), jnp.float32)
    beta = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)
    prev_specular = jnp.zeros((n,), bool)
    # pdf of the previous BSDF sample, for MIS weighting of emission hits
    prev_pdf = jnp.zeros((n,), jnp.float32)
    ray_o, ray_d = o, d
    # original lane of each row, for unsorting the film at the end
    lane = jnp.arange(n, dtype=jnp.int32)
    # ray-cast accounting for the benchmark: closest-hit casts on live lanes
    # plus shadow casts the estimator needs (an equivalent scalar/CUDA tracer
    # would trace exactly these), split by wave class so throughput
    # regressions localize themselves
    n_rays = jnp.zeros((), jnp.float32)
    n_rays_primary = jnp.zeros((), jnp.float32)
    n_rays_bounce = jnp.zeros((), jnp.float32)
    n_rays_shadow = jnp.zeros((), jnp.float32)

    for bounce in range(max_depth + 1):
        # dead lanes trace nothing: tmin=+inf / tmax=-1 fails every slab and
        # primitive test outright, so the BVH walks drop them in one step
        tmin = jnp.where(active, pack.ray_eps, jnp.inf)
        tmax = jnp.where(active, jnp.inf, -1.0)
        hit = scene_pack.intersect(meta, pack, ray_o, ray_d, tmin, tmax)
        cast = jnp.sum(active.astype(jnp.float32))
        n_rays = n_rays + cast
        if bounce == 0:
            n_rays_primary = n_rays_primary + cast
        else:
            n_rays_bounce = n_rays_bounce + cast

        # -- emission (reference: src/integrator.cc:328-337) --------------
        if nee:
            gate = active if bounce == 0 else (active & prev_specular)
        else:
            gate = active
        le_hit = scene_pack.emitted(pack, hit)
        le_env = light_ops.env_radiance(meta, pack, n)
        le = jnp.where(hit.valid[:, None], le_hit, le_env)
        L = L + jnp.where(gate[:, None], beta * le, 0.0)

        if mis and bounce > 0:
            # MIS complement of NEE: credit BSDF-sampled emitter hits that
            # the reference simply drops (reference has no MIS).
            w_area = jnp.zeros((n,), jnp.float32)
            for li_idx in range(nl):
                lm = meta.lights[li_idx]
                if lm.kind == scene_pack.LIGHT_AREA:
                    pl = light_ops.pdf_li(meta, pack, li_idx, ray_o, ray_d)
                    is_this = hit.valid & (hit.light_id == li_idx)
                    w = power_heuristic(1.0, prev_pdf, 1.0, pl)
                    w_area = jnp.where(is_this, w, w_area)
                elif lm.kind == scene_pack.LIGHT_ENV:
                    pl = light_ops.pdf_li(meta, pack, li_idx, ray_o, ray_d)
                    w = power_heuristic(1.0, prev_pdf, 1.0, pl)
                    w_area = jnp.where(~hit.valid, w, w_area)
            gate_mis = active & ~prev_specular
            L = L + jnp.where(
                gate_mis[:, None], beta * le * _sg(w_area)[:, None], 0.0
            )

        # -- termination (reference: src/integrator.cc:340-343) ------------
        if bounce >= max_depth:
            break
        cont = active & hit.valid

        # -- resolve BSDF lobe (reference: src/integrator.cc:348) ----------
        u_vertex = rng.vertex_uniforms(u, bounce, nl)
        mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = (
            scene_pack.gather_material(pack, hit.mat_id))
        c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex_id)
        lobe = bsdf_ops.make_lobe(
            mat_kind, c0, c1, s0, s1, remap, rng.stream_lobe(u_vertex),
            mf_kind=mf_kind,
        )
        delta = bsdf_ops.is_delta(lobe)
        frame = frame_from_z(hit.normal)
        wo_local = to_local(frame, hit.wo)

        # -- NEE over all lights (reference: src/integrator.cc:357-372) ----
        # One occluded() call per light.
        nee_batch = []
        for li_idx in range(nl if nee else 0):
            if meta.lights[li_idx].static_black:
                continue  # zero-radiance light: skip the shadow traversal
            ls = light_ops.sample_li(
                meta, pack, li_idx, hit.position, rng.stream_nee(u_vertex, li_idx)
            )
            wi_local = to_local(frame, _sg(ls.wi))
            f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                                lobes=meta.present_lobes,
                                mf_kinds=meta.present_mf_kinds)
            useful = (
                cont
                & ~delta
                & (_sg(ls.pdf) > 0.0)
                & ~is_black(ls.li)
                & ~is_black(f)
            )
            shadow = jnp.sum(useful.astype(jnp.float32))
            n_rays = n_rays + shadow
            n_rays_shadow = n_rays_shadow + shadow
            if mis and not scene_pack.light_is_delta(meta, li_idx):
                pb = bsdf_ops.pdf(lobe, wo_local, wi_local,
                                  lobes=meta.present_lobes,
                                  mf_kinds=meta.present_mf_kinds)
                w_l = power_heuristic(1.0, _sg(ls.pdf), 1.0, _sg(pb))
            else:
                w_l = 1.0
            contrib = (
                beta
                * f
                * ls.li
                * (absdot(_sg(ls.wi), hit.normal) / jnp.maximum(_sg(ls.pdf), 1e-20))[
                    :, None
                ]
            ) * (w_l if isinstance(w_l, float) else w_l[:, None])
            nee_batch.append((useful, _sg(ls.pos), contrib))
        for useful, pos, contrib in nee_batch:
            # deep bounces skip the shadow-batch re-sort: the wave is
            # already liveness-compacted by the earlier bounce sorts
            occ = scene_pack.occluded(
                meta, pack, hit.position, pos, mask=useful,
                sort=(sort_rays and bounce < 2))
            L = L + jnp.where((useful & ~occ)[:, None], contrib, 0.0)

        # -- BSDF sampling (reference: src/integrator.cc:375-379) ----------
        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                             lobes=meta.present_lobes,
                             mf_kinds=meta.present_mf_kinds)
        wi_world = _sg(to_world(frame, bs.wi))
        pdf_b = _sg(bs.pdf)
        sample_ok = (pdf_b > 0.0) & ~is_black(bs.f)

        # -- russian roulette (reference: src/integrator.cc:383-393) -------
        if bounce >= 3:
            q = jnp.maximum(0.05, 1.0 - max_component(_sg(bs.f)))
            rr_die = rng.stream_rr(u_vertex, nl) < q
            rr_scale = 1.0 / jnp.maximum(1.0 - q, 1e-6)
        else:
            rr_die = jnp.zeros((n,), bool)
            rr_scale = jnp.ones((n,), jnp.float32)

        active = cont & sample_ok & ~rr_die
        weight = (
            bs.f
            * (absdot(wi_world, hit.normal) / jnp.maximum(pdf_b, 1e-20))[:, None]
            * rr_scale[:, None]
        )
        beta = jnp.where(active[:, None], beta * weight, beta)
        prev_specular = bs.is_specular
        prev_pdf = pdf_b
        ray_o = jnp.where(active[:, None], hit.position, ray_o)
        ray_d = jnp.where(active[:, None], wi_world, ray_d)

        if sort_rays and bounce < 3:
            # regroup lanes for the next bounce's traversal (ops/sort.py):
            # argsort (ONE 2-operand sort, compiled once and reused by
            # every sort site in the program) + ONE bitcast-packed [N,19]
            # gather; a variadic lax.sort carrying the state compiles much
            # more slowly per site. Deep bounces (>=3) skip the re-sort:
            # active lanes only ever die, so the dead tail from the last
            # sort persists.
            world_lo = pack.world_center - pack.world_radius
            world_inv = 1.0 / jnp.maximum(2.0 * pack.world_radius, 1e-12)
            needs = sort_ops.bvh_needed(
                meta, pack, _sg(ray_o), _sg(ray_d),
                jnp.where(active, pack.ray_eps, jnp.inf),
                jnp.where(active, jnp.inf, -1.0))
            skey = sort_ops.ray_sort_key(
                active, _sg(ray_o), _sg(ray_d), _sg(world_lo),
                jnp.broadcast_to(_sg(world_inv), (3,)), needs_bvh=needs,
            )
            perm = jnp.argsort(skey)
            key_u = rng.is_key_array(u)
            f32 = jnp.float32
            bc = lambda x: jax.lax.bitcast_convert_type(x, f32)
            icols = [bc(lane)]
            if key_u:
                icols += [bc(jax.random.key_data(u).astype(jnp.uint32))]
            state = jnp.concatenate(
                [L, beta, ray_o, ray_d, prev_pdf[:, None],
                 active[:, None].astype(f32),
                 prev_specular[:, None].astype(f32)]
                + [c if c.ndim == 2 else c[:, None] for c in icols],
                axis=1)[perm]
            L, beta = state[:, 0:3], state[:, 3:6]
            ray_o, ray_d = state[:, 6:9], state[:, 9:12]
            prev_pdf = state[:, 12]
            active = state[:, 13] > 0.5
            prev_specular = state[:, 14] > 0.5
            ib = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
            lane = ib(state[:, 15])
            if key_u:
                u = jax.random.wrap_key_data(
                    jax.lax.bitcast_convert_type(
                        state[:, 16:18], jnp.int32).astype(jnp.uint32))
            else:
                u = u[perm]

    if sort_rays:
        # undo the lane permutation so row i is pixel i again (gather by
        # the inverse permutation)
        L = L[jnp.argsort(lane)]
    # invalid-sample guard (reference: src/integrator.cc:104 checks validity)
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    if with_stats:
        return L, {"rays": n_rays, "rays_primary": n_rays_primary,
                   "rays_bounce": n_rays_bounce,
                   "rays_shadow": n_rays_shadow}
    return L


def li_debug_normal(meta, pack, o, d):
    """Normal visualization (reference: src/integrator.h:44-58):
    abs(normal) on hit, black on miss."""
    n = o.shape[0]
    tmin = jnp.full((n,), 1.0, jnp.float32) * pack.ray_eps
    tmax = jnp.full((n,), jnp.inf, jnp.float32)
    hit = scene_pack.intersect(meta, pack, o, d, tmin, tmax)
    return jnp.where(hit.valid[:, None], jnp.abs(hit.normal), 0.0)


def li_whitted(meta, pack, o, d, u, max_depth: int):
    """Whitted-style integrator (reference: src/integrator.cc:115-220):
    NEE at every hit; continuation only through specular lobes.

    Expressed iteratively with masks: a path keeps bouncing only while its
    lobe is delta (specular reflect/transmit), matching the reference's
    recursion which only recurses through SpecularReflect/Transmit.
    """
    n = o.shape[0]
    nl = meta.n_lights
    L = jnp.zeros((n, 3), jnp.float32)
    beta = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)
    ray_o, ray_d = o, d

    for bounce in range(max_depth + 1):
        tmin = jnp.where(active, pack.ray_eps, jnp.inf)
        tmax = jnp.where(active, jnp.inf, -1.0)
        hit = scene_pack.intersect(meta, pack, ray_o, ray_d, tmin, tmax)
        le_hit = scene_pack.emitted(pack, hit)
        le_env = light_ops.env_radiance(meta, pack, n)
        le = jnp.where(hit.valid[:, None], le_hit, le_env)
        # Whitted adds emission at every depth (reference: src/integrator.cc:127-137)
        L = L + jnp.where(active[:, None], beta * le, 0.0)

        if bounce >= max_depth:
            break
        cont = active & hit.valid

        u_vertex = rng.vertex_uniforms(u, bounce, nl)
        mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = (
            scene_pack.gather_material(pack, hit.mat_id))
        c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex_id)
        lobe = bsdf_ops.make_lobe(
            mat_kind, c0, c1, s0, s1, remap, rng.stream_lobe(u_vertex),
            mf_kind=mf_kind,
        )
        delta = bsdf_ops.is_delta(lobe)
        frame = frame_from_z(hit.normal)
        wo_local = to_local(frame, hit.wo)

        for li_idx in range(nl):
            if meta.lights[li_idx].static_black:
                continue
            ls = light_ops.sample_li(
                meta, pack, li_idx, hit.position, rng.stream_nee(u_vertex, li_idx)
            )
            wi_local = to_local(frame, _sg(ls.wi))
            f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                                lobes=meta.present_lobes,
                                mf_kinds=meta.present_mf_kinds)
            useful = cont & ~delta & (_sg(ls.pdf) > 0.0) & ~is_black(ls.li) & ~is_black(f)
            occ = scene_pack.occluded(meta, pack, hit.position, _sg(ls.pos),
                                      mask=useful)
            contrib = beta * f * ls.li * (
                absdot(_sg(ls.wi), hit.normal) / jnp.maximum(_sg(ls.pdf), 1e-20)
            )[:, None]
            L = L + jnp.where((useful & ~occ)[:, None], contrib, 0.0)

        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                             lobes=meta.present_lobes,
                             mf_kinds=meta.present_mf_kinds)
        wi_world = _sg(to_world(frame, bs.wi))
        pdf_b = _sg(bs.pdf)
        # continue only through specular lobes (reference: src/integrator.cc:171-220)
        active = cont & delta & (pdf_b > 0.0) & ~is_black(bs.f)
        weight = bs.f * (absdot(wi_world, hit.normal) / jnp.maximum(pdf_b, 1e-20))[:, None]
        beta = jnp.where(active[:, None], beta * weight, beta)
        ray_o = jnp.where(active[:, None], hit.position, ray_o)
        ray_d = jnp.where(active[:, None], wi_world, ray_d)

    return jnp.where(jnp.isfinite(L), L, 0.0)
