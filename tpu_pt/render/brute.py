"""Brute-force flat-list intersector — the CPU-oracle accelerator.

This is SURVEY.md §4 item 1: "a deliberately naive, pure-jax.numpy renderer —
flat primitive list — that the fast paths must allclose against".  It
tests every ray against every primitive (O(R·T) memory), so it is only used
on small scenes and small ray chunks; correctness over speed by design.

The BVH and wavefront paths must produce identical hit records (same nearest
primitive, same t/u/v) so the full renderers agree bit-for-bit modulo float
association.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from tpu_pt.core.intersect import INF, ray_sphere, ray_triangle
from tpu_pt.scene.types import Scene


class Hit(NamedTuple):
    hit: jnp.ndarray   # (R, 1) bool
    t: jnp.ndarray     # (R, 1) f32 (INF when miss)
    prim: jnp.ndarray  # (R,) int32 — [0,T) triangle id, [T,T+S) sphere id
    u: jnp.ndarray     # (R, 1) barycentric u (triangles only)
    v: jnp.ndarray     # (R, 1) barycentric v


def _tri_soa(scene: Scene):
    v0 = scene.vertices[scene.tri_idx[:, 0]]
    v1 = scene.vertices[scene.tri_idx[:, 1]]
    v2 = scene.vertices[scene.tri_idx[:, 2]]
    return v0, v1 - v0, v2 - v0


def intersect(scene: Scene, ro, rd, t_min, t_max) -> Hit:
    """Nearest hit against all primitives.  ro/rd: (R,3); t_min/t_max: (R,1)."""
    v0, e1, e2 = _tri_soa(scene)
    # (R, T, 1) broadcasting: rays on axis 0, prims on axis 1.
    h_t, t_t, u_t, v_t = ray_triangle(
        ro[:, None, :], rd[:, None, :], v0[None], e1[None], e2[None],
        t_min[:, None, :], t_max[:, None, :],
    )
    t_tri = t_t[..., 0]                                   # (R, T)
    best_tri = jnp.argmin(t_tri, axis=1)                  # (R,)
    t_best_tri = jnp.min(t_tri, axis=1, keepdims=True)    # (R, 1)
    u_best = jnp.take_along_axis(u_t[..., 0], best_tri[:, None], axis=1)
    v_best = jnp.take_along_axis(v_t[..., 0], best_tri[:, None], axis=1)

    h_s, t_s, _ = ray_sphere(
        ro[:, None, :], rd[:, None, :],
        scene.sph_center[None], scene.sph_radius[None, :, None],
        t_min[:, None, :], t_max[:, None, :],
    )
    t_sph = t_s[..., 0]                                   # (R, S)
    best_sph = jnp.argmin(t_sph, axis=1)
    t_best_sph = jnp.min(t_sph, axis=1, keepdims=True)

    take_tri = t_best_tri <= t_best_sph
    t = jnp.minimum(t_best_tri, t_best_sph)
    prim = jnp.where(
        take_tri[..., 0], best_tri, scene.n_tris + best_sph
    ).astype(jnp.int32)
    return Hit(
        hit=t < INF,
        t=t,
        prim=prim,
        u=jnp.where(take_tri, u_best, 0.0),
        v=jnp.where(take_tri, v_best, 0.0),
    )


def occluded(scene: Scene, ro, rd, t_max):
    """Any-hit test for shadow rays: (R,1) bool."""
    t_min = jnp.zeros_like(t_max)
    v0, e1, e2 = _tri_soa(scene)
    h_t, _, _, _ = ray_triangle(
        ro[:, None, :], rd[:, None, :], v0[None], e1[None], e2[None],
        t_min[:, None, :], t_max[:, None, :],
    )
    h_s, _, _ = ray_sphere(
        ro[:, None, :], rd[:, None, :],
        scene.sph_center[None], scene.sph_radius[None, :, None],
        t_min[:, None, :], t_max[:, None, :],
    )
    any_hit = jnp.any(h_t[..., 0], axis=1) | jnp.any(h_s[..., 0], axis=1)
    return any_hit[:, None]
