"""The path-tracing integrator, shared by every acceleration backend.

Batched re-design of the reference's ``PathTracer::trace_ray`` /
``estimate_direct_lighting`` / ``estimate_indirect_lighting`` recursion
(SURVEY.md §2 row 13, §3.1).  The per-ray recursion becomes a bounce-major
loop over a whole batch of rays with masked lanes; Russian roulette kills
lanes statistically exactly like the reference kills recursion.

The integrator is parameterized by an *intersector* — a pair of closures
``(intersect, occluded)`` — so the brute-force oracle, the flattened-BVH
traversal and the wavefront cluster traversal all share THIS shading code.
That is what makes BASELINE.json's "image allclose vs CPU oracle" gates
meaningful: backends can only differ in which primitive they report nearest,
never in shading math or random numbers (counter-based RNG; see
core/sampling.py).

Light transport semantics (matching the reference, SURVEY.md §3.1):
  - radiance = emission-at-first-hit + NEE direct + BSDF-sampled indirect;
  - emission is only added on camera rays and after *delta* bounces, since
    next-event estimation already accounts for light hits after diffuse
    bounces (the asst3 ``includeLe`` convention);
  - Russian roulette starts at bounce ``rr_start`` with continuation
    probability ``rr_prob`` (throughput compensated).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from tpu_pt.config import RenderConfig
from tpu_pt.core.sampling import draws
from tpu_pt.core.vecmath import dot, make_coord_space, normalize, to_local, to_world
from tpu_pt.render import bsdf as bsdf_mod
from tpu_pt.render import lights as lights_mod
from tpu_pt.render.brute import Hit
from tpu_pt.scene.types import Scene

# draw_id layout: stride per bounce; see core/sampling.py for why draw ids
# make randomness order-invariant across backends.
DRAW_JITTER = 0
_STRIDE = 64
_LIGHT0 = 0      # + li*ns + s   (light NEE draws)
_BSDF = 48       # bsdf lobe+direction draws
_RR = 49         # russian roulette


class ShadeInfo(NamedTuple):
    p: jnp.ndarray        # (R, 3) hit position (reparameterized on vertices)
    ns: jnp.ndarray       # (R, 3) shading normal (unit)
    ng: jnp.ndarray       # (R, 3) geometric normal (unit)
    mat: bsdf_mod.MatProps


def shade_info(scene: Scene, ro, rd, hit: Hit) -> ShadeInfo:
    """Gather hit-point geometry + material.

    Differentiability (SURVEY.md §7 hard-part 4): barycentrics u,v and hit
    distance t are *detached*; the triangle hit position is recomputed as
    (1-u-v)·v0 + u·v1 + v·v2 so d(p)/d(vertices) flows — this is the
    reparameterized-hit-point trick BASELINE.json's "detached-sampling
    reparameterized gradients" refers to.  Occlusion boundaries are not
    differentiated (documented estimator scope).
    """
    is_tri = hit.prim < scene.n_tris
    tri_id = jnp.where(is_tri, hit.prim, 0)
    sph_id = jnp.where(is_tri, 0, hit.prim - scene.n_tris)

    idx = scene.tri_idx[tri_id]                      # (R, 3)
    v0 = scene.vertices[idx[:, 0]]
    v1 = scene.vertices[idx[:, 1]]
    v2 = scene.vertices[idx[:, 2]]
    u = jax.lax.stop_gradient(hit.u)
    v = jax.lax.stop_gradient(hit.v)
    w0 = 1.0 - u - v
    p_tri = w0 * v0 + u * v1 + v * v2
    n0 = scene.normals[idx[:, 0]]
    n1 = scene.normals[idx[:, 1]]
    n2 = scene.normals[idx[:, 2]]
    ns_tri = normalize(w0 * n0 + u * n1 + v * n2)
    ng_tri = normalize(jnp.cross(v1 - v0, v2 - v0))
    # Keep geometric normal on the same side as the shading normal.
    ng_tri = jnp.where(dot(ng_tri, ns_tri) < 0.0, -ng_tri, ng_tri)

    t = jax.lax.stop_gradient(hit.t)
    center = scene.sph_center[sph_id]
    p_sph = ro + t * rd
    ns_sph = normalize(p_sph - center)

    is_tri_c = is_tri[:, None]
    p = jnp.where(is_tri_c, p_tri, p_sph)
    ns = jnp.where(is_tri_c, ns_tri, ns_sph)
    ng = jnp.where(is_tri_c, ng_tri, ns_sph)
    mat_id = jnp.where(is_tri, scene.tri_mat[tri_id], scene.sph_mat[sph_id])
    return ShadeInfo(p=p, ns=ns, ng=ng, mat=bsdf_mod.gather_mat(scene.materials, mat_id))


def radiance(
    scene: Scene,
    intersect_fn: Callable,
    occluded_fn: Callable,
    ro,
    rd,
    ray_ids,
    key,
    cfg: RenderConfig,
):
    """Estimate radiance along a batch of camera rays.  (R,3) -> (R,3)."""
    R = ro.shape[0]
    beta = jnp.ones((R, 3), jnp.float32)
    L = jnp.zeros((R, 3), jnp.float32)
    alive = jnp.ones((R, 1), bool)
    include_le = jnp.ones((R, 1), bool)
    t_min = jnp.zeros((R, 1), jnp.float32)
    t_max = jnp.full((R, 1), 1e30, jnp.float32)

    n_lights = scene.lights.count
    n_hits = 1 if cfg.direct_only else cfg.max_depth + 1

    for depth in range(n_hits):
        base = 1 + depth * _STRIDE
        hit = intersect_fn(scene, ro, rd, t_min, t_max)
        # Miss → environment radiance (reference: EnvironmentLight on escaped
        # rays); Scene.env_map is (1,1,3) zeros when no environment is set.
        from tpu_pt.render.envmap import eval_env

        L = L + jnp.where(
            alive & ~hit.hit & include_le,
            beta * eval_env(scene.env_map, rd), 0.0,
        )
        alive = alive & hit.hit
        si = shade_info(scene, ro, rd, hit)
        wo_world = -rd
        tb, bb = make_coord_space(si.ns)
        wo = to_local(wo_world, tb, bb, si.ns)

        # Emission at the hit (one-sided: emitting face only).
        front = dot(wo_world, si.ns) > 0.0
        L = L + jnp.where(
            alive & include_le & front, beta * si.mat.emission, 0.0
        )

        # ---- Next-event estimation (direct lighting). ----
        delta_b = bsdf_mod.is_delta(si.mat)
        ns_samples = cfg.ns_area_light
        for li in range(n_lights):
            for s in range(ns_samples):
                u = draws(key, ray_ids, base + _LIGHT0 + li * ns_samples + s, 2)
                ls = lights_mod.sample_light(
                    scene.lights, li, si.p, u, env_map=scene.env_map,
                    env_tables=(scene.env_marg_cdf, scene.env_cond_cdf))
                wi_l = to_local(ls.wi, tb, bb, si.ns)
                f = bsdf_mod.eval_f(si.mat, wo, wi_l)
                cos_s = jnp.maximum(wi_l[..., 2:3], 0.0)
                contrib_mask = (
                    alive
                    & ~delta_b
                    & (cos_s > 0.0)
                    & (jnp.max(f * ls.radiance, axis=-1, keepdims=True) > 0.0)
                )
                # Shadow ray (cast unconditionally; lanes are masked).
                shadow_o = si.p + si.ng * jnp.where(
                    dot(ls.wi, si.ng) > 0.0, cfg.eps, -cfg.eps
                )
                occ = occluded_fn(
                    scene, shadow_o, ls.wi, ls.dist * (1.0 - 1e-3)
                )
                w = f * ls.radiance * cos_s / (ls.pdf * ns_samples)
                L = L + jnp.where(contrib_mask & ~occ, beta * w, 0.0)

        # ---- Scatter to the next bounce. ----
        if depth == n_hits - 1:
            break
        u3 = draws(key, ray_ids, base + _BSDF, 3)
        bs = bsdf_mod.sample(si.mat, wo, jax.lax.stop_gradient(u3))
        wi_world = to_world(jax.lax.stop_gradient(bs.wi), tb, bb, si.ns)
        beta = beta * bs.weight
        include_le = bs.delta
        alive = alive & bs.valid
        # Russian roulette.
        if depth + 1 >= cfg.rr_start:
            u_rr = draws(key, ray_ids, base + _RR, 1)
            alive = alive & (u_rr < cfg.rr_prob)
            beta = beta / cfg.rr_prob
        ro = si.p + si.ng * jnp.where(dot(wi_world, si.ng) > 0.0, cfg.eps, -cfg.eps)
        rd = wi_world

    return jnp.where(alive | True, L, L)  # L already masked per-term


def render_chunk(scene, cam, cfg: RenderConfig, key, pixel_ids, sample_ids,
                 intersect_fn, occluded_fn):
    """Radiance for a flat chunk of (pixel, sample) pairs -> (R, 3)."""
    from tpu_pt.core.camera import generate_rays, pixel_xy

    ray_ids = pixel_ids * cfg.spp + sample_ids
    jitter = draws(key, ray_ids, DRAW_JITTER, 2)
    xy = pixel_xy(cfg.width, cfg.height, pixel_ids, jax.lax.stop_gradient(jitter))
    ro, rd = generate_rays(cam, xy)
    return radiance(scene, intersect_fn, occluded_fn, ro, rd, ray_ids, key, cfg)
