"""BSDF lobes: resolution from materials, evaluation, pdf, and sampling —
fully batched, divergence-free.

This module replaces three reference layers at once:

* FMaterial::Scattering, which heap-allocates a BSDF object per intersection
  (reference: src/material.h:18-24, src/material.cc:12-43) — here a material
  row plus one uniform resolves to a `Lobe` SoA row (plastic's stochastic
  Lambert-vs-GGX pick, reference: src/material.cc:14-16, becomes a per-lane
  select);
* the FBSDF virtual hierarchy (reference: src/bsdf.h:268-731) — eval/pdf/
  sample are computed for every lobe kind on every lane and merged with
  `jnp.where` on the kind tag, polymorphism without divergence;
* the local-frame trig helpers (reference: src/bsdf.h:17-60).

All directions here are in the local shading frame (z = geometric normal);
the integrator owns the world<->local transform, mirroring how FBSDF wraps
its protected *_Local methods (reference: src/bsdf.h:268-332).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .linalg import PI, INV_PI, INV_2PI, dot, normalize, luminance, face_forward
from . import microfacet as mf
from .fresnel import fresnel_dielectric, fresnel_conductor

# Material kinds (rows of the scene's material table).
MAT_MATTE = 0    # -> Lambert (reference: src/material.h:27-41)
MAT_MIRROR = 1   # -> specular reflection (reference: src/material.h:45-59)
MAT_GLASS = 2    # -> Fresnel specular (reference: src/material.h:63-81)
MAT_PLASTIC = 3  # -> stochastic Lambert/GGX (reference: src/material.h:85-110)
MAT_METAL = 4    # -> GGX + conductor Fresnel (reference: src/material.h:113-137)
# Rough glass: stochastic 50/50 mix of the reference's FMicrofacetReflection
# and FMicrofacetTransmission components — the reference implements the
# transmission BSDF but never instantiates it from any material
# (reference: src/bsdf.cc:80-145; SURVEY.md §2 #27). c0=Kr, c1=Kt,
# s0=roughness, s1=eta.
MAT_ROUGHGLASS = 5
# Energy-conserving modified Phong: c0=Ks, s0=exponent
# (reference: src/bsdf.h:555-631 FPhongSpecularReflection).
MAT_PHONG = 6

# Lobe kinds (resolved, concrete scattering models).
LOBE_LAMBERT = 0
LOBE_SPECULAR = 1
LOBE_FRESNEL = 2
LOBE_MICROFACET = 3
LOBE_PHONG = 4
LOBE_MICROFACET_TRANS = 5


class Lobe(NamedTuple):
    kind: jnp.ndarray      # [N] int32
    f0: jnp.ndarray        # [N,3] albedo / R / Kr / microfacet R / phong Ks
    f1: jnp.ndarray        # [N,3] Kt / conductor eta
    f2: jnp.ndarray        # [N,3] conductor k
    a0: jnp.ndarray        # [N] glass eta_t / alpha_x / phong exponent
    a1: jnp.ndarray        # [N] alpha_y
    fr_conductor: jnp.ndarray  # [N] bool: microfacet fresnel is conductor
    fr_eta_i: jnp.ndarray  # [N] microfacet dielectric fresnel eta_i
    fr_eta_t: jnp.ndarray  # [N] microfacet dielectric fresnel eta_t
    mf_kind: jnp.ndarray   # [N] int32: mf.GGX / mf.BECKMANN


class BSDFSample(NamedTuple):
    wi: jnp.ndarray           # [N,3] local
    f: jnp.ndarray            # [N,3]
    pdf: jnp.ndarray          # [N]
    is_specular: jnp.ndarray  # [N] bool


def is_delta(lobe: Lobe) -> jnp.ndarray:
    """Delta lobes skip NEE (reference: src/bsdf.h:221-224, integrator.cc:357)."""
    return (lobe.kind == LOBE_SPECULAR) | (lobe.kind == LOBE_FRESNEL)


def _sanitize(lobe: Lobe) -> Lobe:
    """Clamp per-kind parameters so every lobe branch is finite on every
    lane. eval/pdf/sample compute ALL kinds and select by tag; without this,
    masked-out branches produce inf (GGX with alpha=0 on a Lambert lane,
    glass with eta=0 on a matte lane, ...) and `where` turns those infs into
    NaN *gradients* (0 * inf) even though the primal is correct."""
    is_mf = (lobe.kind == LOBE_MICROFACET) | (lobe.kind == LOBE_MICROFACET_TRANS)
    is_fr = lobe.kind == LOBE_FRESNEL
    is_ph = lobe.kind == LOBE_PHONG
    alpha0 = jnp.where(is_mf, jnp.maximum(lobe.a0, 1e-4), 0.25)
    alpha1 = jnp.where(is_mf, jnp.maximum(lobe.a1, 1e-4), 0.25)
    eta_glass = jnp.where(is_fr, jnp.maximum(lobe.a0, 1.0001), 1.5)
    a0 = jnp.where(is_fr, eta_glass, alpha0)
    a0 = jnp.where(is_ph, jnp.maximum(lobe.a0, 1e-3), a0)
    return lobe._replace(
        a0=a0,
        a1=alpha1,
        fr_eta_i=jnp.maximum(lobe.fr_eta_i, 1e-3),
        fr_eta_t=jnp.maximum(lobe.fr_eta_t, 1e-3),
    )


def _same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def make_lobe(mat_kind, c0, c1, s0, s1, remap, u_lobe, mf_kind=None) -> Lobe:
    """Resolve per-hit material rows into concrete lobes.

    mat_kind [N] int32; c0, c1 [N,3]; s0, s1 [N]; remap [N] bool;
    u_lobe [N] the plastic stochastic-pick uniform
    (reference: src/material.cc:12-29); mf_kind [N] int32 microfacet
    distribution per material row (mf.GGX / mf.BECKMANN), GGX if None.
    """
    n = mat_kind.shape[0]
    f32 = jnp.float32
    zero3 = jnp.zeros((n, 3), f32)
    one = jnp.ones((n,), f32)

    # plastic: Qd = lum(Kd) / (lum(Kd)+lum(Ks)) (reference: src/material.h:94-98)
    ld = luminance(c0)
    ls = luminance(c1)
    qd = ld / jnp.maximum(ld + ls, 1e-12)
    plastic_diffuse = u_lobe < qd

    remapped_s0 = jnp.where(remap, mf.roughness_to_alpha(s0), s0)
    remapped_s1 = jnp.where(remap, mf.roughness_to_alpha(s1), s1)

    rough_reflect = u_lobe < 0.5
    kind = jnp.select(
        [
            mat_kind == MAT_MATTE,
            mat_kind == MAT_MIRROR,
            mat_kind == MAT_GLASS,
            (mat_kind == MAT_PLASTIC) & plastic_diffuse,
            (mat_kind == MAT_PLASTIC) & ~plastic_diffuse,
            mat_kind == MAT_METAL,
            (mat_kind == MAT_ROUGHGLASS) & rough_reflect,
            (mat_kind == MAT_ROUGHGLASS) & ~rough_reflect,
            mat_kind == MAT_PHONG,
        ],
        [LOBE_LAMBERT, LOBE_SPECULAR, LOBE_FRESNEL, LOBE_LAMBERT,
         LOBE_MICROFACET, LOBE_MICROFACET, LOBE_MICROFACET,
         LOBE_MICROFACET_TRANS, LOBE_PHONG],
        LOBE_LAMBERT,
    ).astype(jnp.int32)

    # plastic diffuse: Kd/Qd (reference: src/material.cc:17)
    f0 = jnp.where(
        ((mat_kind == MAT_PLASTIC) & plastic_diffuse)[..., None],
        c0 / jnp.maximum(qd, 1e-12)[..., None],
        c0,
    )
    # plastic glossy: Ks/(1-Qd) (reference: src/material.cc:27); metal: R=1
    # (reference: src/material.cc:42)
    f0 = jnp.where(
        ((mat_kind == MAT_PLASTIC) & ~plastic_diffuse)[..., None],
        c1 / jnp.maximum(1.0 - qd, 1e-12)[..., None],
        f0,
    )
    f0 = jnp.where((mat_kind == MAT_METAL)[..., None], jnp.ones_like(c0), f0)
    # rough glass: 2x compensation for the 50/50 lobe pick
    is_rg = mat_kind == MAT_ROUGHGLASS
    f0 = jnp.where((is_rg & rough_reflect)[..., None], 2.0 * c0, f0)
    f0 = jnp.where((is_rg & ~rough_reflect)[..., None], 2.0 * c1, f0)

    f1 = jnp.where((mat_kind == MAT_GLASS)[..., None], c1, zero3)   # Kt
    f1 = jnp.where((mat_kind == MAT_METAL)[..., None], c0, f1)      # conductor eta
    f2 = jnp.where((mat_kind == MAT_METAL)[..., None], c1, zero3)   # conductor k

    a0 = jnp.where(mat_kind == MAT_GLASS, s0, 0.0)                  # eta_t
    a0 = jnp.where(mat_kind == MAT_PLASTIC, remapped_s0, a0)        # alpha
    a0 = jnp.where(mat_kind == MAT_METAL, remapped_s0, a0)
    a0 = jnp.where(is_rg, remapped_s0, a0)
    a0 = jnp.where(mat_kind == MAT_PHONG, s0, a0)                   # exponent
    a1 = jnp.where(mat_kind == MAT_PLASTIC, remapped_s0, 0.0)
    a1 = jnp.where(mat_kind == MAT_METAL, remapped_s1, a1)
    a1 = jnp.where(is_rg, remapped_s0, a1)

    return Lobe(
        kind=kind,
        f0=f0, f1=f1, f2=f2,
        a0=a0, a1=a1,
        fr_conductor=(mat_kind == MAT_METAL),
        # plastic uses FresnelDielectric(1.5, 1.0) (reference: src/material.cc:21)
        fr_eta_i=jnp.where(mat_kind == MAT_PLASTIC, 1.5, one),
        # rough glass: dielectric interface (1, eta=s1)
        fr_eta_t=jnp.where(is_rg, jnp.maximum(s1, 1.0001), one),
        mf_kind=(jnp.full((n,), mf.GGX, jnp.int32) if mf_kind is None
                 else mf_kind.astype(jnp.int32)),
    )


# ---------------------------------------------------------------------------
# Per-kind eval / pdf.
# ---------------------------------------------------------------------------

def _eval_lambert(lobe: Lobe, wo, wi):
    """f = albedo/pi with same-hemisphere guard (reference: src/bsdf.h:347-355)."""
    ok = _same_hemisphere(wo, wi)
    return jnp.where(ok[..., None], lobe.f0 * INV_PI, 0.0)


def _pdf_lambert(wo, wi):
    """(reference: src/bsdf.h:357-360)"""
    ok = _same_hemisphere(wo, wi)
    return jnp.where(ok, jnp.abs(wi[..., 2]) * INV_PI, 0.0)


def _microfacet_fresnel(lobe: Lobe, cos_i):
    """Select conductor vs dielectric fresnel for the microfacet lobe
    (reference: src/bsdf.cc:16-24)."""
    f_cond = fresnel_conductor(cos_i, 1.0, lobe.f1, lobe.f2)
    f_diel = fresnel_dielectric(cos_i, lobe.fr_eta_i, lobe.fr_eta_t)[..., None]
    return jnp.where(lobe.fr_conductor[..., None], f_cond, f_diel)


def _eval_microfacet(lobe: Lobe, wo, wi, mf_kinds=None):
    """Torrance-Sparrow (reference: src/bsdf.cc:35-50)."""
    cos_o = jnp.abs(wo[..., 2])
    cos_i = jnp.abs(wi[..., 2])
    wh_raw = wo + wi
    degenerate = (cos_o < 1e-9) | (cos_i < 1e-9) | (dot(wh_raw, wh_raw) < 1e-18)
    wh = normalize(wh_raw)
    wh_ff = face_forward(wh, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], wh.dtype), wh.shape))
    fr = _microfacet_fresnel(lobe, dot(wi, wh_ff))
    d_term = mf.d(lobe.mf_kind, wh, lobe.a0, lobe.a1, mf_kinds)
    g_term = mf.g(lobe.mf_kind, wo, wi, lobe.a0, lobe.a1, mf_kinds)
    f = lobe.f0 * (d_term * g_term)[..., None] * fr / jnp.maximum(
        4.0 * cos_i * cos_o, 1e-12
    )[..., None]
    return jnp.where(degenerate[..., None], 0.0, f)


def _pdf_microfacet(lobe: Lobe, wo, wi, mf_kinds=None):
    """(reference: src/bsdf.cc:52-57)"""
    ok = _same_hemisphere(wo, wi)
    wh = normalize(wo + wi)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh, lobe.a0, lobe.a1, mf_kinds) / jnp.maximum(
        4.0 * dot(wo, wh), 1e-12
    )
    return jnp.where(ok & (dot(wo, wh) > 0.0), p, 0.0)


def _trans_eta(lobe: Lobe, wo):
    """eta = etaB/etaA when exiting along the normal side, else etaA/etaB
    (reference: src/bsdf.cc:94)."""
    eta_a = lobe.fr_eta_i
    eta_b = lobe.fr_eta_t
    return jnp.where(wo[..., 2] > 0.0, eta_b / eta_a, eta_a / eta_b)


def _eval_microfacet_trans(lobe: Lobe, wo, wi, mf_kinds=None):
    """Walter-style transmissive microfacet (reference: src/bsdf.cc:85-110)."""
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    eta = _trans_eta(lobe, wo)
    wh = normalize(wo + wi * eta[..., None])
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    dot_o = dot(wo, wh)
    dot_i = dot(wi, wh)
    invalid = (
        _same_hemisphere(wo, wi)
        | (jnp.abs(cos_o) < 1e-9) | (jnp.abs(cos_i) < 1e-9)
        | (dot_o * dot_i > 0.0)
    )
    fr = fresnel_dielectric(dot_o, lobe.fr_eta_i, lobe.fr_eta_t)
    sqrt_denom = dot_o + eta * dot_i
    d_term = mf.d(lobe.mf_kind, wh, lobe.a0, lobe.a1, mf_kinds)
    g_term = mf.g(lobe.mf_kind, wo, wi, lobe.a0, lobe.a1, mf_kinds)
    factor = 1.0 / jnp.maximum(eta, 1e-6)
    mag = jnp.abs(
        d_term * g_term * eta * eta * jnp.abs(dot_i) * jnp.abs(dot_o)
        * factor * factor
        / jnp.maximum(jnp.abs(cos_i * cos_o) * sqrt_denom * sqrt_denom, 1e-12)
    )
    f = lobe.f0 * ((1.0 - fr) * mag)[..., None]
    return jnp.where(invalid[..., None], 0.0, f)


def _pdf_microfacet_trans(lobe: Lobe, wo, wi, mf_kinds=None):
    """(reference: src/bsdf.cc:112-126)"""
    eta = _trans_eta(lobe, wo)
    wh = normalize(wo + wi * eta[..., None])
    dot_o = dot(wo, wh)
    dot_i = dot(wi, wh)
    invalid = _same_hemisphere(wo, wi) | (dot_o * dot_i > 0.0)
    sqrt_denom = dot_o + eta * dot_i
    dwh_dwi = jnp.abs(eta * eta * dot_i) / jnp.maximum(sqrt_denom * sqrt_denom, 1e-12)
    # pdf_wh expects wh in the +z hemisphere relative to wo's side
    wh_up = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh_up, lobe.a0, lobe.a1, mf_kinds) * dwh_dwi
    return jnp.where(invalid, 0.0, p)


def _sample_microfacet_trans(lobe: Lobe, wo, u, mf_kinds=None):
    """(reference: src/bsdf.cc:128-145)"""
    from .linalg import refract as _refract

    wh = mf.sample_wh(lobe.mf_kind, wo, lobe.a0, lobe.a1, u, mf_kinds)
    eta_s = jnp.where(
        wo[..., 2] > 0.0,
        lobe.fr_eta_i / lobe.fr_eta_t,
        lobe.fr_eta_t / lobe.fr_eta_i,
    )
    wi, refr_ok = _refract(wo, wh, eta_s)
    wi = normalize(wi)
    ok = (dot(wo, wh) >= 0.0) & refr_ok & (jnp.abs(wo[..., 2]) > 1e-9)
    f = _eval_microfacet_trans(lobe, wo, wi)
    p = _pdf_microfacet_trans(lobe, wo, wi)
    return (
        wi,
        jnp.where(ok[..., None], f, 0.0),
        jnp.where(ok, p, 0.0),
    )


def _eval_phong(lobe: Lobe, wo, wi):
    """Energy-conserving modified Phong (reference: src/bsdf.h:569-580)."""
    ok = _same_hemisphere(wo, wi)
    wr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos_alpha = dot(wr, wi)
    pos = cos_alpha > 0.0
    # grad-safe pow: 0**p has a NaN derivative wrt p
    base = jnp.where(pos, cos_alpha, 0.5)
    rho = lobe.f0 * ((lobe.a0 + 2.0) * INV_2PI)[..., None]
    f = rho * jnp.where(pos, base ** jnp.maximum(lobe.a0, 1e-6), 0.0)[..., None]
    return jnp.where(ok[..., None], f, 0.0)


def _pdf_phong(lobe: Lobe, wo, wi):
    """Cosine-lobe pdf about the mirror direction (reference: src/bsdf.h:624-628)."""
    wr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos_t = dot(wr, wi)
    pos = cos_t > 0.0
    base = jnp.where(pos, cos_t, 0.5)
    p = (lobe.a0 + 1.0) * base ** jnp.maximum(lobe.a0, 1e-6) * INV_2PI
    return jnp.where(pos, p, 0.0)


ALL_LOBES = (LOBE_LAMBERT, LOBE_SPECULAR, LOBE_FRESNEL, LOBE_MICROFACET,
             LOBE_PHONG, LOBE_MICROFACET_TRANS)


def eval_f(lobe: Lobe, wo, wi, lobes=None, mf_kinds=None) -> jnp.ndarray:
    """World-free local-frame f; delta lobes evaluate to 0
    (reference: src/bsdf.h:405-413, 470-478).

    `lobes` — optional static tuple of lobe kinds that can occur in the
    scene (SceneMeta.present_lobes); branches for absent kinds are skipped
    at trace time, a large win for scenes using few material kinds.
    `mf_kinds` — the analogous static tuple of microfacet distribution
    kinds (SceneMeta.present_mf_kinds): a GGX-only scene compiles no
    Beckmann erf/erfinv ops and vice versa."""
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    out = jnp.zeros(wo.shape, wo.dtype)
    if LOBE_LAMBERT in lobes:
        out = jnp.where((lobe.kind == LOBE_LAMBERT)[..., None],
                        _eval_lambert(lobe, wo, wi), out)
    if LOBE_MICROFACET in lobes:
        out = jnp.where((lobe.kind == LOBE_MICROFACET)[..., None],
                        _eval_microfacet(lobe, wo, wi, mf_kinds), out)
    if LOBE_PHONG in lobes:
        out = jnp.where((lobe.kind == LOBE_PHONG)[..., None],
                        _eval_phong(lobe, wo, wi), out)
    if LOBE_MICROFACET_TRANS in lobes:
        out = jnp.where((lobe.kind == LOBE_MICROFACET_TRANS)[..., None],
                        _eval_microfacet_trans(lobe, wo, wi, mf_kinds), out)
    return out


def pdf(lobe: Lobe, wo, wi, lobes=None, mf_kinds=None) -> jnp.ndarray:
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    out = jnp.zeros(wo.shape[:-1], wo.dtype)
    if LOBE_LAMBERT in lobes:
        out = jnp.where(lobe.kind == LOBE_LAMBERT, _pdf_lambert(wo, wi), out)
    if LOBE_MICROFACET in lobes:
        out = jnp.where(lobe.kind == LOBE_MICROFACET,
                        _pdf_microfacet(lobe, wo, wi, mf_kinds), out)
    if LOBE_PHONG in lobes:
        out = jnp.where(lobe.kind == LOBE_PHONG, _pdf_phong(lobe, wo, wi), out)
    if LOBE_MICROFACET_TRANS in lobes:
        out = jnp.where(lobe.kind == LOBE_MICROFACET_TRANS,
                        _pdf_microfacet_trans(lobe, wo, wi, mf_kinds), out)
    return out


# ---------------------------------------------------------------------------
# Sampling. Every kind is sampled on every lane and the result selected by
# the kind tag — no divergence, one fused elementwise kernel.
# ---------------------------------------------------------------------------

def _sample_lambert(lobe: Lobe, wo, u):
    """Cosine-hemisphere with z-flip into wo's hemisphere
    (reference: src/bsdf.h:362-377)."""
    from .sampling import sample_cosine_hemisphere

    wi = sample_cosine_hemisphere(u)
    wi = jnp.where(
        (wo[..., 2] < 0.0)[..., None],
        wi * jnp.array([1.0, 1.0, -1.0], wi.dtype),
        wi,
    )
    return wi, _eval_lambert(lobe, wo, wi), _pdf_lambert(wo, wi)


def _sample_specular(lobe: Lobe, wo):
    """Perfect mirror: f=R/|cos|, pdf=1 (reference: src/bsdf.h:415-430)."""
    wi = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    f = lobe.f0 / jnp.maximum(jnp.abs(wi[..., 2]), 1e-9)[..., None]
    return wi, f, jnp.ones(wo.shape[:-1], wo.dtype)


def _sample_fresnel(lobe: Lobe, wo, u):
    """Glass: RR between specular reflection (w.p. F) and refraction
    (reference: src/bsdf.h:480-540). Branch-free: both branches computed."""
    eta_i = jnp.ones_like(lobe.a0)
    eta_t = lobe.a0
    cos_o = wo[..., 2]
    F = fresnel_dielectric(cos_o, eta_i, eta_t)
    pick_reflect = u[..., 0] < F

    # reflect branch
    wi_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    f_r = lobe.f0 * F[..., None] / jnp.maximum(jnp.abs(wi_r[..., 2]), 1e-9)[..., None]

    # refract branch
    entering = cos_o > 0.0
    n_loc = jnp.where(
        entering[..., None],
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], wo.dtype), wo.shape),
        jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0], wo.dtype), wo.shape),
    )
    etaI = jnp.where(entering, eta_i, eta_t)
    etaT = jnp.where(entering, eta_t, eta_i)
    eta = etaI / etaT
    from .linalg import refract as _refract

    wi_t, ok = _refract(wo, n_loc, eta)
    # radiance scaling (etaI/etaT)^2 (reference: src/bsdf.h:525-526)
    ft = lobe.f1 * ((1.0 - F) * eta * eta)[..., None]
    f_t = jnp.where(
        ok[..., None],
        ft / jnp.maximum(jnp.abs(wi_t[..., 2]), 1e-9)[..., None],
        0.0,
    )

    wi = jnp.where(pick_reflect[..., None], wi_r, wi_t)
    f = jnp.where(pick_reflect[..., None], f_r, f_t)
    p = jnp.where(pick_reflect, F, jnp.where(ok, 1.0 - F, 0.0))
    return wi, f, p


def _sample_microfacet(lobe: Lobe, wo, u, mf_kinds=None):
    """(reference: src/bsdf.cc:59-78)"""
    wh = mf.sample_wh(lobe.mf_kind, wo, lobe.a0, lobe.a1, u, mf_kinds)
    wi = -wo + 2.0 * dot(wo, wh)[..., None] * wh
    ok = (dot(wo, wh) >= 0.0) & _same_hemisphere(wo, wi) & (jnp.abs(wo[..., 2]) > 1e-9)
    f = _eval_microfacet(lobe, wo, wi)
    p = mf.pdf_wh(lobe.mf_kind, wo, wh, lobe.a0, lobe.a1, mf_kinds) / jnp.maximum(
        4.0 * dot(wo, wh), 1e-12
    )
    return (
        wi,
        jnp.where(ok[..., None], f, 0.0),
        jnp.where(ok, p, 0.0),
    )


def _sample_phong(lobe: Lobe, wo, u):
    """Cosine-lobe about the mirror direction (reference: src/bsdf.h:590-622)."""
    from .linalg import frame_from_z, to_world

    from .linalg import safe_sqrt

    phi = 2.0 * PI * u[..., 0]
    exp = jnp.maximum(lobe.a0, 1e-6)
    cos_t = jnp.maximum(u[..., 1], 1e-12) ** (1.0 / (exp + 1.0))
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    local = jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1
    )
    wr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    wi = to_world(frame_from_z(wr), local)
    wi = jnp.where(
        (wo[..., 2] < 0.0)[..., None],
        wi * jnp.array([1.0, 1.0, -1.0], wi.dtype),
        wi,
    )
    return wi, _eval_phong(lobe, wo, wi), _pdf_phong(lobe, wo, wi)


def sample(lobe: Lobe, wo, u, lobes=None, mf_kinds=None) -> BSDFSample:
    """Sample the lobe kinds present, select by tag. u: [N,2]; `lobes` is
    the optional static present-kind tuple (see eval_f)."""
    lobes = ALL_LOBES if lobes is None else lobes
    lobe = _sanitize(lobe)
    samplers = {
        LOBE_LAMBERT: lambda: _sample_lambert(lobe, wo, u),
        LOBE_SPECULAR: lambda: _sample_specular(lobe, wo),
        LOBE_FRESNEL: lambda: _sample_fresnel(lobe, wo, u),
        LOBE_MICROFACET: lambda: _sample_microfacet(lobe, wo, u, mf_kinds),
        LOBE_PHONG: lambda: _sample_phong(lobe, wo, u),
        LOBE_MICROFACET_TRANS: lambda: _sample_microfacet_trans(lobe, wo, u, mf_kinds),
    }
    wi = jnp.zeros(wo.shape, wo.dtype)
    f = jnp.zeros(wo.shape, wo.dtype)
    p = jnp.zeros(wo.shape[:-1], wo.dtype)
    for k in lobes:
        wi_k, f_k, p_k = samplers[k]()
        sel = lobe.kind == k
        wi = jnp.where(sel[..., None], wi_k, wi)
        f = jnp.where(sel[..., None], f_k, f)
        p = jnp.where(sel, p_k, p)
    # the iterative integrator tags specular bounces to gate next-hit emission
    # (reference: src/integrator.cc:381)
    return BSDFSample(wi=wi, f=f, pdf=p, is_specular=is_delta(lobe))
