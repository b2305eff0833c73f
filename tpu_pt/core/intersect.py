"""Primitive intersection: Möller–Trumbore ray-triangle and ray-sphere.

Batched counterpart of the reference's ``Triangle::intersect`` /
``Sphere::intersect`` virtual methods (SURVEY.md §2 row 6).  Instead of a
per-primitive virtual call, every function here is a dense batched test —
typically (R rays) × (T triangles) or gathered per-ray candidate lists — and
returns hit masks + parameters, never early-exits.  Divergence is handled by
the caller via masking (SURVEY.md §7 design stance).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_pt.core.vecmath import cross, dot

# Plain Python float, NOT jnp.float32(1e30): a Python literal folds into
# the compiled program as a constant, while a module-level device array
# closed over inside a jitted loop body becomes a captured buffer.
INF = 1e30


def ray_triangle(ro, rd, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore, batched with broadcasting.

    ro, rd: (..., 3) ray origin/direction.
    v0:     (..., 3) triangle vertex 0.
    e1, e2: (..., 3) edges v1-v0, v2-v0.
    t_min, t_max: (..., 1) valid t interval.

    Returns (hit, t, u, v): hit is (..., 1) bool; t/u/v are (..., 1) f32 with
    t = INF where no hit.  u, v are barycentrics of v1, v2 (w0 = 1-u-v).
    """
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    # No backface culling (reference traces glass interiors).  Guard the
    # near-parallel case: |det| tiny → treat as miss.
    parallel = jnp.abs(det) < 1e-12
    inv_det = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, det))
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return hit, jnp.where(hit, t, INF), u, v


def ray_sphere(ro, rd, center, radius, t_min, t_max):
    """Ray-sphere intersection (both roots tested, nearest valid returned).

    Mirrors the reference's ``Sphere::intersect`` two-root solve
    (SURVEY.md §2 row 6).  Shapes broadcast like ray_triangle; radius is
    (..., 1).  Returns (hit, t, n_unscaled) where n_unscaled = hitpoint -
    center (caller normalizes).
    """
    oc = ro - center
    # rd need not be unit length; use full quadratic.
    a = dot(rd, rd)
    b = 2.0 * dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 1.0 / jnp.maximum(2.0 * a, 1e-20)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    valid0 = has_root & (t0 >= t_min) & (t0 <= t_max)
    valid1 = has_root & (t1 >= t_min) & (t1 <= t_max)
    t = jnp.where(valid0, t0, jnp.where(valid1, t1, INF))
    hit = valid0 | valid1
    n_unscaled = (ro + t * rd) - center
    return hit, jnp.where(hit, t, INF), n_unscaled
