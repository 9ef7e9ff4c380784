"""Per-phase timing of ONE bunny spp-wave on the device JAX runs on.

Replicates li_path's wave sequence (same RNG streams, same NEE masks, no
ray sorting — the default) but jits and times each traversal phase
separately:

  cast b      closest-hit intersect() of bounce b
  occl b/Li   the occluded() call for light Li at bounce b

and then the whole wave (li_path) in one program. "other" is the whole wave
minus the phases: shading, light and BSDF sampling, RNG. Also prints
live-lane / useful-shadow-lane counts per phase so cost can be read per
needy lane, and the estimator rays/s of the whole wave. Run:

    python scripts/wave_profile.py [width=1024] [reps=5]
"""
from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def profile(width: int = 1024, reps: int = 5, log=print) -> list:
    """Time each phase; returns [(label, ms)] with "whole wave" last."""
    from jet_pbrt_tpu.scene.scenes import bunny_scene
    from jet_pbrt_tpu.models import camera as camera_mod
    from jet_pbrt_tpu.models.integrators import li_path
    from jet_pbrt_tpu.ops import bsdf as bsdf_ops
    from jet_pbrt_tpu.ops import lights as light_ops
    from jet_pbrt_tpu.ops import rng
    from jet_pbrt_tpu.ops.linalg import (
        frame_from_z, to_local, to_world, max_component, is_black,
    )
    from jet_pbrt_tpu.ops.sort import morton_pixel_ids
    from jet_pbrt_tpu.scene import pack as scene_pack

    _sg = jax.lax.stop_gradient
    scene = bunny_scene()
    meta, pack = scene.meta, scene.pack
    max_depth = 5
    n = width * width
    nl = meta.n_lights
    dev = jax.devices()[0]
    log(f"scene={meta.name} {width}x{width} lights={nl} "
        f"device={dev.platform}:{dev.device_kind}")

    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, width))
    ids = jnp.asarray(morton_pixel_ids(width))
    keys0 = rng.lane_keys(0, 0, ids)
    jitter = rng.camera_jitter(keys0)
    x = (ids % width).astype(jnp.float32) + jitter[:, 0]
    y = (ids // width).astype(jnp.float32) + jitter[:, 1]
    o, d = camera_mod.generate_rays(cam, jnp.stack([x, y], axis=-1))

    rows = []

    def timed(label, fn, *args):
        f = jax.jit(fn)
        out = f(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps * 1e3
        rows.append((label, dt))
        log(f"  {label:<18} {dt:9.2f} ms")
        return out

    # ---- the wave, phase by phase ---------------------------------------
    u = keys0
    active = jnp.ones((n,), bool)
    ray_o, ray_d = o, d

    for bounce in range(max_depth + 1):
        tmin = jnp.where(active, pack.ray_eps, jnp.inf)
        tmax = jnp.where(active, jnp.inf, -1.0)
        live = int(active.sum())
        log(f"bounce {bounce}: live={live} ({100*live/n:.1f}%)")
        hit = timed(
            f"cast b{bounce}",
            lambda o_, d_, t0_, t1_: scene_pack.intersect(
                meta, pack, o_, d_, t0_, t1_),
            ray_o, ray_d, tmin, tmax)

        if bounce >= max_depth:
            break
        cont = active & hit.valid

        u_vertex = rng.vertex_uniforms(u, bounce, nl)
        mat_kind, c0, c1, s0, s1, remap, tex_id, mf_kind = (
            scene_pack.gather_material(pack, hit.mat_id))
        c0 = scene_pack.effective_kd(meta, pack, hit, c0, tex_id)
        lobe = bsdf_ops.make_lobe(
            mat_kind, c0, c1, s0, s1, remap, rng.stream_lobe(u_vertex),
            mf_kind=mf_kind)
        delta = bsdf_ops.is_delta(lobe)
        frame = frame_from_z(hit.normal)
        wo_local = to_local(frame, hit.wo)

        for li_idx in range(nl):
            if meta.lights[li_idx].static_black:
                continue
            ls = light_ops.sample_li(
                meta, pack, li_idx, hit.position,
                rng.stream_nee(u_vertex, li_idx))
            wi_local = to_local(frame, _sg(ls.wi))
            f = bsdf_ops.eval_f(lobe, wo_local, wi_local,
                                lobes=meta.present_lobes,
                                mf_kinds=meta.present_mf_kinds)
            useful = (cont & ~delta & (_sg(ls.pdf) > 0.0)
                      & ~is_black(ls.li) & ~is_black(f))
            nu = int(useful.sum())
            kind = meta.lights[li_idx].kind
            log(f"  [occl b{bounce}/L{li_idx} kind={kind} "
                f"useful={nu} ({100*nu/n:.1f}%)]")
            timed(
                f"occl b{bounce}/L{li_idx}",
                lambda p_, q_, m_: scene_pack.occluded(
                    meta, pack, p_, q_, mask=m_),
                hit.position, _sg(ls.pos), useful)

        bs = bsdf_ops.sample(lobe, wo_local, rng.stream_bsdf(u_vertex, nl),
                             lobes=meta.present_lobes,
                             mf_kinds=meta.present_mf_kinds)
        wi_world = _sg(to_world(frame, bs.wi))
        pdf_b = _sg(bs.pdf)
        sample_ok = (pdf_b > 0.0) & ~is_black(bs.f)
        if bounce >= 3:
            q = jnp.maximum(0.05, 1.0 - max_component(_sg(bs.f)))
            rr_die = rng.stream_rr(u_vertex, nl) < q
        else:
            rr_die = jnp.zeros((n,), bool)
        active = cont & sample_ok & ~rr_die
        ray_o = jnp.where(active[:, None], hit.position, ray_o)
        ray_d = jnp.where(active[:, None], wi_world, ray_d)

    phases = sum(dt for _, dt in rows)
    _, st = timed(
        "whole wave",
        lambda o_, d_, u_: li_path(meta, pack, o_, d_, u_, max_depth,
                                   with_stats=True),
        o, d, keys0)
    whole = rows[-1][1]
    rays = float(st["rays"])
    log("\n== summary ==")
    for label, dt in rows[:-1]:
        log(f"{label:<18} {dt:9.2f} ms  ({100*dt/whole:5.1f}% of wave)")
    log(f"{'other':<18} {whole - phases:9.2f} ms  "
        f"({100*(whole - phases)/whole:5.1f}% of wave)")
    log(f"{'whole wave':<18} {whole:9.2f} ms")
    log(f"estimator rays this wave: {rays:.0f} "
        f"(primary {float(st['rays_primary']):.0f}, bounce "
        f"{float(st['rays_bounce']):.0f}, shadow "
        f"{float(st['rays_shadow']):.0f})")
    log(f"whole wave: {rays / (whole / 1e3) / 1e6:.2f} M estimator rays/s")
    return rows


def main():
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    from jet_pbrt_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    profile(width, reps)


if __name__ == "__main__":
    main()
