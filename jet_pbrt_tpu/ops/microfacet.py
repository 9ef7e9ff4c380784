"""Microfacet normal distributions: Trowbridge-Reitz (GGX) and Beckmann.

Equivalent of the reference's MicrofacetDistribution hierarchy
(reference: src/microfacet.h, src/microfacet.cc). Anisotropic (alpha_x,
alpha_y); visible-normal (VNDF) sampling is the default, matching the
reference's samplevis=true (reference: src/microfacet.h:51,70-71).

Design divergence (documented): for GGX the reference inverts the
slope-space CDF numerically (TrowbridgeReitzSample11 with polynomial fits
and Newton steps, reference: src/microfacet.cc:256-357). We instead use
Heitz's 2018 spherical-cap VNDF construction — it samples the *same*
D_visible distribution (identical pdf) with ~10 flops and no data-dependent
iteration, which is exactly what lockstep batched lanes want. Beckmann has no such
closed form, so its VNDF sampler (the reference's default samplevis=true
branch, reference: src/microfacet.cc:212-254) is the slope-space erf-CDF
inversion re-done branch-free: the reference's early-exit Newton/bisection
loop becomes a fixed 10-step vectorized iteration whose converged lanes
simply keep producing zero-sized updates.

All directions are in the local shading frame (z = normal).
"""
from __future__ import annotations

import jax.numpy as jnp

from .linalg import PI, dot, normalize

GGX = 0
BECKMANN = 1


def roughness_to_alpha(roughness: jnp.ndarray) -> jnp.ndarray:
    """pbrt's log-polynomial remap (reference: src/microfacet.h:45-50)."""
    x = jnp.log(jnp.maximum(roughness, 1e-3))
    return (
        1.62142
        + 0.819955 * x
        + 0.1734 * x * x
        + 0.0171201 * x ** 3
        + 0.000640711 * x ** 4
    )


def _trig(w):
    """Local-frame trig helpers (reference: src/bsdf.h:17-60)."""
    cos2 = jnp.clip(w[..., 2] ** 2, 0.0, 1.0)
    sin2 = 1.0 - cos2
    sin_theta = jnp.sqrt(sin2)
    safe_sin = jnp.maximum(sin_theta, 1e-12)
    cos_phi = jnp.where(sin_theta > 1e-12, w[..., 0] / safe_sin, 1.0)
    sin_phi = jnp.where(sin_theta > 1e-12, w[..., 1] / safe_sin, 0.0)
    return cos2, sin2, jnp.clip(cos_phi, -1, 1), jnp.clip(sin_phi, -1, 1)


def d_ggx(wh, ax, ay):
    """GGX NDF (reference: src/microfacet.cc:181-189)."""
    cos2, sin2, cphi, sphi = _trig(wh)
    tan2 = sin2 / jnp.maximum(cos2, 1e-12)
    e = (cphi ** 2 / jnp.maximum(ax ** 2, 1e-12) + sphi ** 2 / jnp.maximum(ay ** 2, 1e-12)) * tan2
    d = 1.0 / (PI * ax * ay * jnp.maximum(cos2, 1e-12) ** 2 * (1.0 + e) ** 2)
    return jnp.where(cos2 > 0.0, d, 0.0)


def lambda_ggx(w, ax, ay):
    """GGX masking Lambda, closed form (reference: src/microfacet.cc:202-210)."""
    cos2, sin2, cphi, sphi = _trig(w)
    abs_tan = jnp.sqrt(sin2 / jnp.maximum(cos2, 1e-12))
    alpha = jnp.sqrt(cphi ** 2 * ax ** 2 + sphi ** 2 * ay ** 2)
    a2t2 = (alpha * abs_tan) ** 2
    lam = 0.5 * (-1.0 + jnp.sqrt(1.0 + a2t2))
    return jnp.where(cos2 > 1e-12, lam, 0.0)


def d_beckmann(wh, ax, ay):
    """Beckmann NDF (reference: src/microfacet.cc:172-179)."""
    cos2, sin2, cphi, sphi = _trig(wh)
    tan2 = sin2 / jnp.maximum(cos2, 1e-12)
    d = jnp.exp(
        -tan2 * (cphi ** 2 / jnp.maximum(ax ** 2, 1e-12) + sphi ** 2 / jnp.maximum(ay ** 2, 1e-12))
    ) / (PI * ax * ay * jnp.maximum(cos2, 1e-12) ** 2)
    return jnp.where(cos2 > 0.0, d, 0.0)


def lambda_beckmann(w, ax, ay):
    """Rational fit (reference: src/microfacet.cc:191-200)."""
    cos2, sin2, cphi, sphi = _trig(w)
    abs_tan = jnp.sqrt(sin2 / jnp.maximum(cos2, 1e-12))
    alpha = jnp.sqrt(cphi ** 2 * ax ** 2 + sphi ** 2 * ay ** 2)
    a = 1.0 / jnp.maximum(alpha * abs_tan, 1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return jnp.where((a >= 1.6) | (cos2 <= 1e-12), 0.0, lam)


def d(kind, wh, ax, ay, kinds=None):
    """kinds: static tuple of distribution kinds present in the scene
    (SceneMeta.present_mf_kinds). A single-kind scene compiles ONLY that
    branch — the Beckmann path costs a 10-step branch-free erfinv loop per
    lane, which GGX-only scenes should never pay (VERDICT r3 task 9)."""
    if kinds is not None and tuple(kinds) == (GGX,):
        return d_ggx(wh, ax, ay)
    if kinds is not None and tuple(kinds) == (BECKMANN,):
        return d_beckmann(wh, ax, ay)
    return jnp.where(kind == GGX, d_ggx(wh, ax, ay), d_beckmann(wh, ax, ay))


def lam(kind, w, ax, ay, kinds=None):
    if kinds is not None and tuple(kinds) == (GGX,):
        return lambda_ggx(w, ax, ay)
    if kinds is not None and tuple(kinds) == (BECKMANN,):
        return lambda_beckmann(w, ax, ay)
    return jnp.where(kind == GGX, lambda_ggx(w, ax, ay), lambda_beckmann(w, ax, ay))


def g1(kind, w, ax, ay, kinds=None):
    """(reference: src/microfacet.h:22-25)"""
    return 1.0 / (1.0 + lam(kind, w, ax, ay, kinds))


def g(kind, wo, wi, ax, ay, kinds=None):
    """(reference: src/microfacet.h:26-28)"""
    return 1.0 / (1.0 + lam(kind, wo, ax, ay, kinds)
                  + lam(kind, wi, ax, ay, kinds))


def _sample_ggx_vndf(wo_up, ax, ay, u):
    """Heitz 2018 spherical-cap VNDF sample; wo_up must have z >= 0."""
    vh = normalize(
        jnp.stack(
            [ax * wo_up[..., 0], ay * wo_up[..., 1], wo_up[..., 2]], axis=-1
        )
    )
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 1e-20)[..., None],
        jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv, jnp.zeros_like(inv)], axis=-1),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], vh.dtype), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    from .linalg import safe_sqrt

    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    pz = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * vh
    wh = normalize(
        jnp.stack(
            [ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6)],
            axis=-1,
        )
    )
    return wh


def _beckmann_slope_sample(cos_theta, u1, u2):
    """Invert the Beckmann visible-slope CDF: P(slope_x) ∝ ∫ of the erf-CDF
    of a unit-roughness Beckmann lobe seen from grazing angle acos(cos_theta)
    (the reference's BeckmannSample11, src/microfacet.cc:234-254 /
    pbrt-v3). Branch-free: normal-incidence and generic lanes both computed,
    the reference's early-exit Newton loop unrolled to 10 guarded steps."""
    from jax.scipy.special import erf, erfinv

    u1 = jnp.clip(u1, 1e-6, 1.0 - 1e-6)
    u2 = jnp.clip(u2, 1e-6, 1.0 - 1e-6)

    # --- normal-incidence lanes: isotropic Gaussian in slope space
    r_ni = jnp.sqrt(-jnp.log1p(-u1))
    sx_ni = r_ni * jnp.cos(2.0 * PI * u2)
    sy_ni = r_ni * jnp.sin(2.0 * PI * u2)

    # --- generic lanes: 1D Newton/bisection on the marginal slope_x CDF
    ni = cos_theta > 0.9999
    cos_safe = jnp.where(ni, 0.5, jnp.clip(cos_theta, -0.9999, 0.9999))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_safe * cos_safe))
    tan_t = sin_t / cos_safe
    cot_t = 1.0 / tan_t

    a = jnp.full_like(u1, -1.0)
    c = erf(cot_t)
    theta = jnp.arccos(cos_safe)
    # cubic fit seeding b near the solution (pbrt-v3 fit)
    fit = 1.0 + theta * (-0.876 + theta * (0.4265 - 0.0594 * theta))
    b = c - (1.0 + c) * (1.0 - u1) ** fit

    sqrt_pi_inv = 1.0 / jnp.sqrt(PI)
    norm = 1.0 / (1.0 + c + sqrt_pi_inv * tan_t * jnp.exp(-cot_t * cot_t))
    for _ in range(10):
        b = jnp.where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = erfinv(jnp.clip(b, -1.0 + 1e-7, 1.0 - 1e-7))
        value = norm * (1.0 + b + sqrt_pi_inv * tan_t * jnp.exp(-inv_erf * inv_erf)) - u1
        deriv = norm * (1.0 - inv_erf * tan_t)
        c = jnp.where(value > 0.0, b, c)
        a = jnp.where(value > 0.0, a, b)
        step = value / jnp.where(jnp.abs(deriv) > 1e-12, deriv, 1.0)
        b = b - jnp.where(jnp.abs(value) < 1e-6, 0.0, step)
    b = jnp.clip(b, -1.0 + 1e-7, 1.0 - 1e-7)
    sx_g = erfinv(b)
    sy_g = erfinv(2.0 * u2 - 1.0)

    sx = jnp.where(ni, sx_ni, sx_g)
    sy = jnp.where(ni, sy_ni, sy_g)
    return sx, sy


def _sample_beckmann_vndf(wo_up, ax, ay, u):
    """Beckmann visible-normal sample via the stretch / sample / rotate /
    unstretch slope-space recipe (reference: src/microfacet.cc:212-254,
    the samplevis=true default; Heitz & d'Eon 2014). wo_up.z >= 0."""
    w_s = normalize(
        jnp.stack([ax * wo_up[..., 0], ay * wo_up[..., 1], wo_up[..., 2]],
                  axis=-1)
    )
    _, sin2, cphi, sphi = _trig(w_s)
    sx, sy = _beckmann_slope_sample(w_s[..., 2], u[..., 0], u[..., 1])
    # rotate slopes into the azimuth of wo, then unstretch
    rx = cphi * sx - sphi * sy
    ry = sphi * sx + cphi * sy
    return normalize(
        jnp.stack([-ax * rx, -ay * ry, jnp.ones_like(rx)], axis=-1)
    )


def sample_wh(kind, wo, ax, ay, u, kinds=None):
    """Sample a visible half-vector (VNDF) for either distribution, with the
    hemisphere flip for wo.z<0 (reference: src/microfacet.cc:212-254 and
    326-357, both samplevis=true — the reference's default for every
    distribution it builds, src/microfacet.h:51,70-71)."""
    flip = wo[..., 2] < 0.0
    wo_up = jnp.where(flip[..., None], -wo, wo)
    if kinds is not None and tuple(kinds) == (GGX,):
        wh = _sample_ggx_vndf(wo_up, ax, ay, u)
    elif kinds is not None and tuple(kinds) == (BECKMANN,):
        wh = _sample_beckmann_vndf(wo_up, ax, ay, u)
    else:
        wh_ggx = _sample_ggx_vndf(wo_up, ax, ay, u)
        wh_beck = _sample_beckmann_vndf(wo_up, ax, ay, u)
        wh = jnp.where((kind == GGX)[..., None], wh_ggx, wh_beck)
    return jnp.where(flip[..., None], -wh, wh)


def pdf_wh(kind, wo, wh, ax, ay, kinds=None):
    """Visible-normal pdf D(wh)·G1(wo)·|wo·wh| / |cosθo| for both
    distributions (reference: src/microfacet.cc:359-365, samplevis=true)."""
    return (
        d(kind, wh, ax, ay, kinds)
        * g1(kind, wo, ax, ay, kinds)
        * jnp.abs(dot(wo, wh))
        / jnp.maximum(jnp.abs(wo[..., 2]), 1e-12)
    )
