"""Counter-based random streams for path tracing.

Stateless replacement for the reference's stateful mt19937_64 samplers
(reference: src/sampler.h:16-185). Instead of mutable per-thread generator
state — which cannot exist inside a traced XLA program — every random number
is a pure function of (seed, sample_index, pixel_id, purpose): we derive one
threefry key per (pixel, sample) lane and draw each purpose's uniforms as a
batched tensor. This makes any (pixel, sample, bounce) recomputable, enables
checkpoint/resume by storing only integer counters, and — unlike the
reference, whose Clone() reuses seed 1234 so all tiles share one stream
(reference: src/sampler.h:135-138, src/integrator.cc:66) — gives every pixel,
sample and bounce an independent stream.

Keys are derived from GLOBAL pixel ids and GLOBAL sample indices only, never
from shard/chunk layout, so a single-chip render, an (8,1) mesh and a (4,2)
mesh all produce the same image (up to float reduction order in the film
merge). The key array is first-class data: the integrator can permute it
along with ray state (ray sorting between bounces) and every lane still
draws its own pixel's stream.

Stream layout per path vertex (one "bounce" of the iterative path integrator,
reference: src/integrator.cc:316-403):

    [0]              lobe/material stochastic pick (plastic Qd pick,
                     reference: src/material.cc:12-29)
    [1 : 1+2L]       2 uniforms per scene light for NEE Sample_Li
    [1+2L : 3+2L]    2 uniforms for BSDF sampling
    [3+2L]           russian-roulette coin
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# Purpose tags folded into the per-lane key. Path-vertex draws use
# PURPOSE_PATH_BASE + bounce.
PURPOSE_CAMERA = 0
PURPOSE_PATH_BASE = 16


def is_key_array(u) -> bool:
    """True when `u` is a typed PRNG key array (per-lane keys) rather than a
    pregenerated uniform tensor (the debug sampler's constant streams)."""
    return jnp.issubdtype(u.dtype, jax.dtypes.prng_key)


def lane_keys(seed: int, sample_index, pixel_ids) -> jax.Array:
    """One key per lane from (seed, global sample index, global pixel id).

    pixel_ids: [N] int32 global pixel indices (y * width + x)."""
    base = jax.random.fold_in(jax.random.key(seed), sample_index)
    return jax.vmap(jax.random.fold_in, (None, 0))(base, pixel_ids)


def camera_jitter(keys: jax.Array, sampler: str = "random",
                  sample_index=None, spp: int | None = None) -> jnp.ndarray:
    """In-pixel jitter [n, 2], the analogue of GetCameraSample's
    (x+u, y+u) offset (reference: src/sampler.h:148-155).

    keys: [n] per-lane keys from `lane_keys`.
    sampler:
      "random"     — i.i.d. uniforms (reference FRandomSampler)
      "stratified" — jittered stratification of the pixel over the spp's
                     ceil(sqrt(spp))^2 grid. The reference declares
                     FStratifiedSampler but stubs it to random
                     (reference: src/sampler.h:158-185 'TODO'); this is the
                     real thing.
      "debug"      — constant 0.5 (reference FDebugSampler,
                     src/sampler.h:109-127, minus its missing-return bug)
    """
    n = keys.shape[0]
    if sampler == "debug":
        return jnp.full((n, 2), 0.5, jnp.float32)
    k = jax.vmap(jax.random.fold_in, (0, None))(keys, PURPOSE_CAMERA)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (2,), jnp.float32))(k)
    if sampler == "stratified":
        assert spp is not None and sample_index is not None
        g = int(np.ceil(np.sqrt(spp)))
        stratum = jnp.asarray(sample_index) % (g * g)
        sx = (stratum % g).astype(jnp.float32)
        sy = (stratum // g).astype(jnp.float32)
        return (jnp.stack([sx, sy], axis=-1) + u) / g
    return u


def debug_path_uniforms(n: int, max_depth: int, n_lights: int) -> jnp.ndarray:
    """All-0.5 path uniforms — FDebugSampler semantics for the transport
    streams. Integrators accept this [n, D+1, S] tensor in place of a key
    array."""
    s = 4 + 2 * n_lights
    return jnp.full((n, max_depth + 1, s), 0.5, jnp.float32)


def vertex_uniforms(u, bounce: int, n_lights: int) -> jnp.ndarray:
    """Per-vertex uniforms [n, S] for one bounce, S = 4 + 2 * n_lights.

    `u` is either a [n] key array (each lane draws its own pixel's stream —
    one batched threefry call, the array-program replacement for the
    reference's sequential GetFloat() calls) or a pregenerated
    [n, max_depth+1, S] tensor (debug sampler)."""
    if not is_key_array(u):
        return u[:, bounce, :]
    s = 4 + 2 * n_lights
    kb = jax.vmap(jax.random.fold_in, (0, None))(
        u, jnp.int32(PURPOSE_PATH_BASE + bounce)
    )
    return jax.vmap(lambda k: jax.random.uniform(k, (s,), jnp.float32))(kb)


def stream_lobe(u_vertex: jnp.ndarray) -> jnp.ndarray:
    """u_vertex is [..., S]; scalar lobe-pick uniform."""
    return u_vertex[..., 0]


def stream_nee(u_vertex: jnp.ndarray, light_index: int) -> jnp.ndarray:
    """2-vector of uniforms for NEE of light `light_index` (static)."""
    return u_vertex[..., 1 + 2 * light_index : 3 + 2 * light_index]


def stream_bsdf(u_vertex: jnp.ndarray, n_lights: int) -> jnp.ndarray:
    base = 1 + 2 * n_lights
    return u_vertex[..., base : base + 2]


def stream_rr(u_vertex: jnp.ndarray, n_lights: int) -> jnp.ndarray:
    return u_vertex[..., 3 + 2 * n_lights]
