"""Batched 3-vector math on `[..., 3]` float32 arrays.

Batched replacement for the reference's scalar FVector3/FFrame/FBounds3
classes (reference: src/geometry.h:22-420). Everything here is shape-
polymorphic over leading batch dims and is plain elementwise work; there are no
classes holding state — a "frame" is just a tuple of three direction arrays.
"""
from __future__ import annotations

import jax.numpy as jnp

# Constants mirroring the reference base runtime (reference: src/pbrt.h:37-46).
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_2PI = 1.0 / (2.0 * PI)
INV_4PI = 1.0 / (4.0 * PI)
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
EPSILON = 1e-4
INFINITY = jnp.inf
# Default ray t_min; doubles as the shadow epsilon. The reference hardwires
# 1e-3 world units (reference: src/geometry.h:395) — fine for its ~1000-unit
# scenes, self-intersection acne at 1e-3-unit scale and light leaks at
# 1e6-unit scale. Scene builds therefore derive a SCALE-RELATIVE epsilon
# (ScenePack.ray_eps = RAY_EPS_REL x scene diameter, see scene/builder.py)
# which the integrators use; this constant remains the reference-faithful
# fallback and the default for raw intersect calls.
RAY_EPS = 1e-3
# relative epsilon: 1e-6 of the scene diameter reproduces the reference's
# 1e-3 on its ~1000-unit scenes while scaling to tiny/huge worlds
RAY_EPS_REL = 1.25e-6


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise dot product of [..., 3] arrays -> [...]."""
    return jnp.sum(a * b, axis=-1)


def absdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(dot(a, b))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length2(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length2(a))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt(max(x, 0)) with a finite gradient at x <= 0.

    Plain sqrt has an infinite derivative at 0, which turns into NaN
    gradients through `where` whenever a clamped branch (e.g. total internal
    reflection) is differentiated. Double-where keeps the primal exact."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize; zero vectors stay (near) zero instead of NaN."""
    return a * jnp.reciprocal(jnp.maximum(length(a), eps))[..., None]


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return length(a - b)


def distance2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return length2(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def face_forward(n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Flip n so it lies in the same hemisphere as v (reference: src/bsdf.h:23-26)."""
    return jnp.where(dot(n, v)[..., None] < 0.0, -n, n)


def reflect(wo: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror wo about n; both pointing away from surface (reference: src/bsdf.h:62-67)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Snell refraction. Returns (wt, ok) where ok=False marks total internal
    reflection (reference: src/bsdf.h:70-88). eta = eta_i / eta_t."""
    cos_i = dot(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = eta[..., None] * (-wi) + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


# ---------------------------------------------------------------------------
# Orthonormal shading frames (reference: src/geometry.h:327-378, FFrame).
# A frame is the tuple (s, t, n) of [..., 3] arrays.
# ---------------------------------------------------------------------------

def frame_from_z(n: jnp.ndarray):
    """Build an orthonormal basis around unit normal n.

    Branch-free version of the reference's SetFromZ |x|>0.99 guard
    (reference: src/geometry.h:372-377): pick the helper axis per-lane.
    """
    nx = jnp.abs(n[..., 0])
    helper = jnp.where(
        (nx > 0.99)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], n.dtype), n.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], n.dtype), n.shape),
    )
    t = normalize(cross(n, helper))
    s = normalize(cross(t, n))
    return s, t, n


def to_local(frame, v: jnp.ndarray) -> jnp.ndarray:
    """World -> local coordinates of the frame (reference: src/geometry.h:351-357)."""
    s, t, n = frame
    return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)


def to_world(frame, v: jnp.ndarray) -> jnp.ndarray:
    """Local -> world (reference: src/geometry.h:359-365)."""
    s, t, n = frame
    return (
        s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]
    )


# ---------------------------------------------------------------------------
# Spherical coordinates (reference: src/geometry.h:191-221).
# ---------------------------------------------------------------------------

def spherical_theta(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v: jnp.ndarray) -> jnp.ndarray:
    phi = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(phi < 0.0, phi + 2.0 * PI, phi)


def spherical_direction(sin_theta, cos_theta, phi) -> jnp.ndarray:
    """Canonical z-up spherical -> cartesian (reference: src/geometry.h:203-208)."""
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_direction_in_frame(sin_theta, cos_theta, phi, frame) -> jnp.ndarray:
    """Spherical direction expressed in an arbitrary basis
    (reference: src/geometry.h:211-221)."""
    return to_world(frame, spherical_direction(sin_theta, cos_theta, phi))


# ---------------------------------------------------------------------------
# Color helpers on [..., 3] RGB arrays (reference: src/color.h).
# ---------------------------------------------------------------------------

def luminance(c: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luma (reference: src/color.h:47-50)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def max_component(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(c, axis=-1)


def is_black(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(c == 0.0, axis=-1)
