#!/usr/bin/env python
"""Benchmark: path-tracing throughput on one GPU, TWO scene classes.

Prints the device and the card's name and power limit, then TWO JSON lines:
  1. cornell box 512^2  (62 tris, brute-force intersection)
  2. bunny 1024^2       (4 instanced bunnies, ~66k-tri shared BLAS,
                         skip-link BVH walk, ops/bvh.py)

Each line: {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N/1e8}

vs_baseline is against the north-star target of 100M rays/s per chip
(BASELINE.md — the reference publishes no numbers). "Rays" counts the casts
the estimator actually needs: closest-hit casts on live path lanes plus
shadow casts with a non-zero potential contribution — the same rays a
scalar/CUDA tracer would trace for this estimator. Exits non-zero when JAX
finds no GPU.
"""
from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def bench_scene(scene, width: int, n_waves: int, max_depth: int = 5,
                morton: bool = False, sort_rays: bool = False) -> float:
    from jet_pbrt_tpu.models import camera as camera_mod
    from jet_pbrt_tpu.models.integrators import li_path
    from jet_pbrt_tpu.ops import rng
    from jet_pbrt_tpu.ops.sort import morton_pixel_ids

    meta = scene.meta
    n = width * width
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, width),
    )
    ids = jnp.asarray(morton_pixel_ids(width) if morton
                      else np.arange(n, dtype=np.int32))

    def step(film, rays, pack, s):
        """One spp wave with donated film accumulator, dispatched
        asynchronously from a Python loop."""
        keys = rng.lane_keys(0, s, ids)
        jitter = rng.camera_jitter(keys)
        x = (ids % width).astype(jnp.float32) + jitter[:, 0]
        y = (ids // width).astype(jnp.float32) + jitter[:, 1]
        o, d = camera_mod.generate_rays(cam, jnp.stack([x, y], axis=-1))
        colors, st = li_path(meta, pack, o, d, keys, max_depth,
                             with_stats=True, sort_rays=sort_rays)
        cls = jnp.stack([st["rays_primary"], st["rays_bounce"],
                         st["rays_shadow"]])
        return film + colors, rays + st["rays"], cls

    stepj = jax.jit(step, donate_argnums=(0,))
    film = jnp.zeros((n, 3), jnp.float32)
    rays = jnp.zeros((), jnp.float32)
    # warmup / compile
    film, rays, cls = stepj(film, rays, scene.pack, jnp.int32(0))
    jax.block_until_ready((film, rays))

    t0 = time.perf_counter()
    for s in range(1, n_waves + 1):
        film, rays, cls = stepj(film, jnp.zeros((), jnp.float32),
                                scene.pack, jnp.int32(s))
    jax.block_until_ready((film, rays))
    dt = time.perf_counter() - t0

    # `rays` holds one wave's count after the timing loop (reset per call)
    per_class = {
        k: round(float(v))
        for k, v in zip(("primary", "bounce", "shadow"), np.asarray(cls))
    }
    return float(rays) * n_waves / dt, per_class


def main() -> None:
    from jet_pbrt_tpu.scene.scenes import cornell_box, bunny_scene
    from jet_pbrt_tpu.utils import device

    device.require_gpu()
    device.enable_compile_cache()
    print(f"device: {json.dumps(device.describe_devices())}", flush=True)
    print(f"card: {device.card_name_and_power_limit()}", flush=True)

    cornell = cornell_box(lambert_only=False, use_bvh=False)
    rps, cls = bench_scene(cornell, width=512, n_waves=32)
    print(json.dumps({
        "metric": "rays/s/chip (cornell path tracing)",
        "value": round(rps),
        "unit": "rays/s",
        "vs_baseline": round(rps / 100e6, 4),
        "rays_per_wave_by_class": cls,
    }), flush=True)

    bunny = bunny_scene()
    rps_b, cls_b = bench_scene(bunny, width=1024, n_waves=16, morton=True)
    print(json.dumps({
        "metric": "rays/s/chip (bunny 4x66k-tri instanced BVH path tracing)",
        "value": round(rps_b),
        "unit": "rays/s",
        "vs_baseline": round(rps_b / 100e6, 4),
        "rays_per_wave_by_class": cls_b,
    }), flush=True)


if __name__ == "__main__":
    main()
