"""Sampling warps, their PDFs, and MIS heuristics — batched over [...]-shaped
uniform inputs.

Batched equivalent of the reference's free-function warps
(reference: src/sampling.h:17-137). All functions take uniforms u with
u[..., 0], u[..., 1] in [0,1) and return arrays with matching batch shape.
"""
from __future__ import annotations

import jax.numpy as jnp

from .linalg import PI, INV_PI, INV_2PI, INV_4PI, PI_OVER_2, PI_OVER_4


def sample_uniform_disk(u: jnp.ndarray) -> jnp.ndarray:
    """Polar warp onto the unit disk (reference: src/sampling.h:17-23)."""
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_concentric_disk(u: jnp.ndarray) -> jnp.ndarray:
    """Shirley-Chiu concentric mapping (reference: src/sampling.h:25-50).

    Branch-free: both quadrant cases are computed and selected with where.
    """
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    safe = lambda d: jnp.where(d == 0.0, 1.0, d)
    theta = jnp.where(
        use_x,
        PI_OVER_4 * (oy / safe(ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / safe(oy)),
    )
    pt = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return jnp.where(degenerate[..., None], 0.0, pt)


def sample_cosine_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere about +z via Malley's method
    (reference: src/sampling.h:53-59)."""
    d = sample_concentric_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def pdf_cosine_hemisphere(cos_theta: jnp.ndarray) -> jnp.ndarray:
    """pdf = cosθ/π (reference: src/sampling.h:61-64)."""
    return cos_theta * INV_PI


def sample_uniform_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    """(reference: src/sampling.h:66-76)"""
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def pdf_uniform_hemisphere(shape=()) -> jnp.ndarray:
    return jnp.full(shape, INV_2PI, dtype=jnp.float32)


def sample_uniform_sphere(u: jnp.ndarray) -> jnp.ndarray:
    """(reference: src/sampling.h:85-96)"""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def pdf_uniform_sphere(shape=()) -> jnp.ndarray:
    return jnp.full(shape, INV_4PI, dtype=jnp.float32)


def sample_uniform_cone(u: jnp.ndarray, cos_theta_max: jnp.ndarray) -> jnp.ndarray:
    """Uniform direction inside a cone about +z (reference: src/sampling.h:100-112)."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def pdf_uniform_cone(cos_theta_max: jnp.ndarray) -> jnp.ndarray:
    """(reference: src/sampling.h:114-119)"""
    return 1.0 / (2.0 * PI * jnp.maximum(1.0 - cos_theta_max, 1e-12))


def sample_uniform_triangle(u: jnp.ndarray) -> jnp.ndarray:
    """Barycentrics (b0, b1) uniform over a triangle
    (reference: src/sampling.h:121-125)."""
    su0 = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


def balance_heuristic(nf, f_pdf, ng, g_pdf) -> jnp.ndarray:
    """(reference: src/sampling.h:128-131)"""
    denom = nf * f_pdf + ng * g_pdf
    return jnp.where(denom > 0.0, nf * f_pdf / jnp.maximum(denom, 1e-20), 0.0)


def power_heuristic(nf, f_pdf, ng, g_pdf) -> jnp.ndarray:
    """beta=2 power heuristic (reference: src/sampling.h:133-137)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, f * f / jnp.maximum(denom, 1e-20), 0.0)
