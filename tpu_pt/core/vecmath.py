"""Batched 3-D vector math.

Batched replacement for the reference's scalar C++ math library
(SURVEY.md §2 row 1: ``CMU462/src/vector3D.*``, ``matrix4x4.*``,
``spectrum.h``).  Everything here operates on arrays whose LAST axis is the
xyz component axis, so a "Vector3D" is any ``(..., 3)`` array and the whole
module is vectorized over arbitrarily many rays at once — there is no scalar
vector class, by design.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b, keepdims: bool = True):
    """Batched dot product over the last axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = True):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v, eps: float = 1e-20):
    """Safe normalize: returns v/|v| with a clamp so the gradient at |v|→0 is
    finite (important for the differentiable pass; SURVEY.md §7 hard-part 4)."""
    n2 = dot(v, v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return v * inv


def reflect(wo, n):
    """Mirror reflection of direction `wo` about normal `n` (both pointing
    away from the surface is NOT assumed; standard -d + 2(d.n)n form with
    wo = outgoing/viewer direction)."""
    return -wo + 2.0 * dot(wo, n) * n


def make_coord_space(n):
    """Orthonormal basis (tangent, bitangent, normal) from unit normal `n`.

    Replaces the reference's ``make_coord_space(Matrix3x3&, Vector3D)``
    (SURVEY.md §2 row 10).  Uses the branchless Duff/Frisvad construction so
    it vectorizes with no data-dependent control flow.
    Returns (t, b) with t, b, n right-handed orthonormal.
    """
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    bcoef = nx * ny * a
    t = jnp.concatenate([1.0 + sign * nx * nx * a, sign * bcoef, -sign * nx], axis=-1)
    b = jnp.concatenate([bcoef, sign + ny * ny * a, -ny], axis=-1)
    return t, b


def to_local(w, t, b, n):
    """World direction -> local shading frame (z = normal)."""
    return jnp.concatenate(
        [dot(w, t), dot(w, b), dot(w, n)], axis=-1
    )


def to_world(w, t, b, n):
    """Local shading-frame direction -> world."""
    return (
        w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n
    )


def luminance(rgb):
    """Rec.709 luma — the reference's ``Spectrum::illum()`` used for Russian
    roulette continuation probability (SURVEY.md §2 row 13)."""
    return rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152 + rgb[..., 2:3] * 0.0722
