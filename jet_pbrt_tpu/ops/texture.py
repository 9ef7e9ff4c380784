"""Texture sampling: solid / 3D sine checker / image (nearest + bilinear).

Batched equivalent of the reference's FTexture hierarchy
(reference: src/texture.h, src/texture.cc) — which is *dead code* there (no
material references any FTexture; SURVEY.md §2 #36). Here textures are wired
into materials for real: a material row carries a texture id, and the
integrator modulates Kd with the texture tap at the hit, keeping texels on
the autodiff tape (texture gradients are a BASELINE config-#4 requirement).

All textures live in one padded [K, TH, TW, 3] array; a tap is a pure
gather + lerp, fully batched.
"""
from __future__ import annotations

import jax.numpy as jnp

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2           # nearest-neighbor, like the reference (texture.cc:38-74)
TEX_IMAGE_BILINEAR = 3  # idiomatic upgrade


def _sample_checker(c0, c1, scale, p):
    """3D sine checker at the world position
    (reference: src/texture.cc:26-35)."""
    s = (
        jnp.sin(scale * p[..., 0])
        * jnp.sin(scale * p[..., 1])
        * jnp.sin(scale * p[..., 2])
    )
    return jnp.where((s < 0.0)[..., None], c0, c1)


def _wrap_uv(uv):
    """Clamp to [0,1] like the reference's clamped lookup
    (reference: src/texture.cc:55-60)."""
    return jnp.clip(uv, 0.0, 1.0)


def _sample_image_nearest(images, wh, tex_id, uv):
    uv = _wrap_uv(uv)
    w = wh[tex_id, 0].astype(jnp.float32)
    h = wh[tex_id, 1].astype(jnp.float32)
    # v-flip (reference: src/texture.cc:63)
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, wh[tex_id, 0] - 1)
    y = jnp.clip(((1.0 - uv[..., 1]) * h).astype(jnp.int32), 0, wh[tex_id, 1] - 1)
    return images[tex_id, y, x]


def _sample_image_bilinear(images, wh, tex_id, uv):
    uv = _wrap_uv(uv)
    w = wh[tex_id, 0].astype(jnp.float32)
    h = wh[tex_id, 1].astype(jnp.float32)
    fx = uv[..., 0] * w - 0.5
    fy = (1.0 - uv[..., 1]) * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0.astype(jnp.float32))[..., None]
    ty = (fy - y0.astype(jnp.float32))[..., None]

    def tap(xi, yi):
        xi = jnp.clip(xi, 0, wh[tex_id, 0] - 1)
        yi = jnp.clip(yi, 0, wh[tex_id, 1] - 1)
        return images[tex_id, yi, xi]

    a = tap(x0, y0)
    b = tap(x0 + 1, y0)
    c = tap(x0, y0 + 1)
    d = tap(x0 + 1, y0 + 1)
    return (a * (1 - tx) + b * tx) * (1 - ty) + (c * (1 - tx) + d * tx) * ty


def sample(pack, tex_id, uv, p):
    """Evaluate texture `tex_id` [N] at hit uv [N,2] / position p [N,3].

    tex_id must be a valid row (callers guard -1 with a where outside).
    """
    kind = pack.tex_kind[tex_id]
    c0 = pack.tex_c0[tex_id]
    c1 = pack.tex_c1[tex_id]
    scale = pack.tex_scale[tex_id]
    out = c0  # solid
    out = jnp.where(
        (kind == TEX_CHECKER)[..., None],
        _sample_checker(c0, c1, scale, p), out,
    )
    if pack.tex_image.shape[0]:
        out = jnp.where(
            (kind == TEX_IMAGE)[..., None],
            _sample_image_nearest(pack.tex_image, pack.tex_wh, tex_id, uv), out,
        )
        out = jnp.where(
            (kind == TEX_IMAGE_BILINEAR)[..., None],
            _sample_image_bilinear(pack.tex_image, pack.tex_wh, tex_id, uv), out,
        )
    return out
