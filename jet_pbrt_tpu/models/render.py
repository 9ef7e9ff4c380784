"""Render orchestration: drive waves of (pixels x 1 spp) through an
integrator megakernel and accumulate the film.

Replaces the reference's thread-pool tile renderer
(reference: src/integrator.cc:12-111, src/parallel.cc): the unit of work is
a *wave* — one sample for a chunk of pixels — instead of a 20-row film strip
per thread, and parallelism comes from batching inside one XLA program (and,
in parallel/render.py, from sharding pixels over the device mesh) instead of
a mutex-guarded task queue.
"""
from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import rng
from . import camera as camera_mod
from . import integrators
from .film import finalize


def _wave_fn(meta, width: int, height: int, max_depth: int,
             integrator: str, mis: bool, nee: bool = True,
             sampler: str = "random", spp: int | None = None,
             seed: int = 0, sort_rays: bool = False,
             with_stats: bool = False):
    """Build the jittable one-wave kernel for a fixed scene meta.

    RNG streams are keyed by (seed, global sample index, global pixel id)
    only — the image is identical for any pixel chunking or device layout.
    with_stats=True (path integrator only) makes the wave return
    (colors, ray counters of li_path)."""

    def wave(pack, cam, ids, sample_index):
        n = ids.shape[0]
        keys = rng.lane_keys(seed, sample_index, ids)
        jitter = rng.camera_jitter(keys, sampler=sampler,
                                   sample_index=sample_index, spp=spp)
        # pixel + in-pixel jitter (reference: src/sampler.h:148-155)
        x = (ids % width).astype(jnp.float32) + jitter[:, 0]
        y = (ids // width).astype(jnp.float32) + jitter[:, 1]
        o, d = camera_mod.generate_rays(cam, jnp.stack([x, y], axis=-1))
        if integrator == "debug":
            return integrators.li_debug_normal(meta, pack, o, d)
        if sampler == "debug":
            u = rng.debug_path_uniforms(n, max_depth, meta.n_lights)
        else:
            u = keys
        if integrator == "whitted":
            return integrators.li_whitted(meta, pack, o, d, u, max_depth)
        return integrators.li_path(meta, pack, o, d, u, max_depth, mis=mis,
                                   nee=nee, sort_rays=sort_rays,
                                   with_stats=with_stats)

    return jax.jit(wave)


def render(scene, width: int, height: int, spp: int, seed: int = 0,
           max_depth: int = 5, integrator: str = "path", mis: bool = False,
           nee: bool = True, sampler: str = "random",
           chunk: int | None = None, clamp: bool = True,
           sort_rays: bool = False, stats: dict | None = None) -> np.ndarray:
    """Full-frame render; returns a linear [H,W,3] numpy image (averaged over
    spp, optionally clamped like the reference's film write,
    reference: src/integrator.cc:108).

    stats: optional dict, filled with wall times and, for the path
    integrator, the estimator's ray counts (models/integrators.py):
    `first_call_s` (the first wave call, compile included), `steady_s` and
    `steady_calls` (every later call), `compile_s` (first call minus the
    mean steady call), and `rays*` summed over the steady calls."""
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, height),
    )
    n_pixels = width * height
    if chunk is None:
        chunk = min(n_pixels, 1 << 18)
    counted = stats is not None and integrator == "path"
    wave = _wave_fn(scene.meta, width, height, max_depth, integrator, mis,
                    nee, sampler=sampler, spp=spp, seed=seed,
                    sort_rays=sort_rays, with_stats=counted)

    accum = np.zeros((n_pixels, 3), np.float64)
    n_waves = 1 if integrator == "debug" else spp
    calls = []   # (wall seconds, ray counters) per wave call
    for s in range(n_waves):
        for c0 in range(0, n_pixels, chunk):
            t0 = time.perf_counter()
            ids = jnp.arange(c0, min(c0 + chunk, n_pixels), dtype=jnp.int32)
            colors = wave(scene.pack, cam, ids, jnp.int32(s))
            colors, rays = colors if counted else (colors, {})
            accum[c0 : c0 + ids.shape[0]] += np.asarray(colors, np.float64)
            calls.append((time.perf_counter() - t0,
                          {k: float(v) for k, v in rays.items()}))
    if stats is not None:
        steady = calls[1:]
        steady_s = sum(dt for dt, _ in steady)
        stats.update(
            first_call_s=calls[0][0], steady_s=steady_s,
            steady_calls=len(steady),
            compile_s=calls[0][0] - steady_s / max(len(steady), 1),
        )
        for k in calls[0][1]:
            stats[k] = sum(r[k] for _, r in steady)

    img = (accum / n_waves).reshape(height, width, 3).astype(np.float32)
    if clamp:
        img = np.clip(img, 0.0, 1.0)
    return img


def render_fn(scene, width: int, height: int, spp: int, seed: int = 0,
              max_depth: int = 5, mis: bool = False):
    """Whole-frame render as ONE jittable function of the scene pack:
    lax.scan over spp waves, film accumulated on device. This is the
    differentiable / benchmarkable entry — grad flows into pack parameters.

    Returns (fn, pack) with fn(pack) -> [H,W,3] linear image.
    """
    meta = scene.meta
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, height),
    )
    n_pixels = width * height
    ids = jnp.arange(n_pixels, dtype=jnp.int32)

    def one_wave(pack, s):
        keys = rng.lane_keys(seed, s, ids)
        jitter = rng.camera_jitter(keys)
        x = (ids % width).astype(jnp.float32) + jitter[:, 0]
        y = (ids // width).astype(jnp.float32) + jitter[:, 1]
        o, d = camera_mod.generate_rays(cam, jnp.stack([x, y], axis=-1))
        return integrators.li_path(meta, pack, o, d, keys, max_depth, mis=mis)

    def fn(pack):
        def step(film, s):
            return film + one_wave(pack, s), None
        film0 = jnp.zeros((n_pixels, 3), jnp.float32)
        film, _ = jax.lax.scan(step, film0, jnp.arange(spp))
        return (film / spp).reshape(height, width, 3)

    return fn, scene.pack
