"""BSDF evaluation and sampling over a material table.

Batched replacement for the reference's BSDF class hierarchy
(SURVEY.md §2 row 10: ``DiffuseBSDF``, ``MirrorBSDF``, ``GlassBSDF``,
``RefractionBSDF``, ``EmissionBSDF`` with virtual ``f(wo,wi)`` /
``sample_f(wo,&wi,&pdf)``).  Virtual dispatch becomes a branchless select
over material *kind*: every kind's result is computed for every ray and the
right one chosen with ``jnp.where`` — cheap elementwise math, divergence-free.

All directions are in the LOCAL shading frame (z = shading normal), wo
points away from the surface toward the viewer, matching the reference's
``make_coord_space`` convention.

Differentiability note (SURVEY.md §7 hard-part 4): sampled directions and
pdfs are *detached* by the integrator (detached sampling); the returned
``f``/``weight`` values carry the albedo/roughness gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_pt.scene.types import (
    MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS, MAT_REFRACT, MAT_EMISSIVE, MAT_GGX,
)


class MatProps(NamedTuple):
    """Material properties gathered per ray (R rows)."""

    kind: jnp.ndarray      # (R,) int32
    albedo: jnp.ndarray    # (R, 3)
    emission: jnp.ndarray  # (R, 3)
    ior: jnp.ndarray       # (R, 1)
    roughness: jnp.ndarray # (R, 1)


def gather_mat(materials, mat_id) -> MatProps:
    return MatProps(
        kind=materials.kind[mat_id],
        albedo=materials.albedo[mat_id],
        emission=materials.emission[mat_id],
        ior=materials.ior[mat_id][..., None],
        roughness=materials.roughness[mat_id][..., None],
    )


def is_delta(mat: MatProps):
    """(R, 1) bool — perfectly specular materials have delta BSDFs; the
    integrator skips next-event estimation for them (reference behavior:
    delta BSDFs return f=0 so direct lighting contributes nothing)."""
    k = mat.kind[..., None]
    return (k == MAT_MIRROR) | (k == MAT_GLASS) | (k == MAT_REFRACT)


def _ggx_alpha(roughness):
    """Perceptual roughness -> GGX alpha (Disney r^2 mapping), clamped away
    from the singular alpha=0 limit so eval/sample stay finite and the
    roughness gradient is smooth on the clamp interior."""
    return jnp.clip(roughness, 0.01, 1.0) ** 2


def _ggx_d(cos_h, alpha):
    """GGX normal distribution D(h) for half-vector cosine cos_h (>0)."""
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(jnp.pi * denom * denom, 1e-12)


def _ggx_g1(cos_v, alpha):
    """Smith masking term G1 for GGX (height-correlated-free form)."""
    a2 = alpha * alpha
    c = jnp.maximum(jnp.abs(cos_v), 1e-6)
    return 2.0 * c / (c + jnp.sqrt(a2 + (1.0 - a2) * c * c))


def _ggx_f(mat: MatProps, wo, wi):
    """Rough-conductor GGX lobe: D*G*F / (4 cosO cosI), F = Schlick with
    F0 = albedo (so albedo AND roughness gradients flow — BASELINE.json
    "BRDF albedo/roughness")."""
    alpha = _ggx_alpha(mat.roughness)
    h = wo + wi
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    cos_h = h[..., 2:3]
    cos_o = jnp.maximum(wo[..., 2:3], 1e-6)
    cos_i = jnp.maximum(wi[..., 2:3], 1e-6)
    d = _ggx_d(cos_h, alpha)
    g = _ggx_g1(wo[..., 2:3], alpha) * _ggx_g1(wi[..., 2:3], alpha)
    oh = jnp.maximum(jnp.sum(wo * h, axis=-1, keepdims=True), 0.0)
    fres = mat.albedo + (1.0 - mat.albedo) * (1.0 - oh) ** 5
    return d * g * fres / (4.0 * cos_o * cos_i)


def eval_f(mat: MatProps, wo, wi):
    """BSDF value f(wo, wi) — (R, 3).  Zero for delta/emissive kinds.

    Diffuse is Lambertian albedo/pi (reference DiffuseBSDF::f); MAT_GGX is
    the rough-conductor microfacet lobe.  Evaluated only for wi in the upper
    hemisphere of the shading frame.
    """
    k = mat.kind[..., None]
    same_side = (wi[..., 2:3] > 0.0) & (wo[..., 2:3] > 0.0)
    f_diffuse = mat.albedo / jnp.pi
    f = jnp.where((k == MAT_DIFFUSE) & same_side, f_diffuse, 0.0)
    f = f + jnp.where((k == MAT_GGX) & same_side, _ggx_f(mat, wo, wi), 0.0)
    return f


def _schlick(cos_i, ior):
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _refract(wo, ior):
    """Local-frame refraction through z=0 plane.

    Returns (wi, tir, eta): refracted direction, total-internal-reflection
    mask, and the relative index eta = n_i/n_t actually used.
    """
    entering = wo[..., 2:3] > 0.0
    eta = jnp.where(entering, 1.0 / ior, ior)
    cos_i = jnp.abs(wo[..., 2:3])
    sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wi = jnp.concatenate(
        [-eta * wo[..., 0:1], -eta * wo[..., 1:2],
         -jnp.sign(wo[..., 2:3]) * cos_t],
        axis=-1,
    )
    return wi, tir, eta


class BsdfSample(NamedTuple):
    wi: jnp.ndarray       # (R, 3) local-frame sampled direction
    weight: jnp.ndarray   # (R, 3) f * |cos| / pdf  (throughput multiplier)
    delta: jnp.ndarray    # (R, 1) bool — sampled a delta lobe
    valid: jnp.ndarray    # (R, 1) bool — sample carries energy


def sample(mat: MatProps, wo, u):
    """Sample the BSDF.  u: (R, 3) uniforms (2 for direction, 1 for lobe
    choice).  Returns BsdfSample; ``weight`` already folds f*|cos|/pdf so the
    integrator multiplies throughput by it directly (this is the standard
    wavefront formulation; the reference returns f and pdf separately from
    ``sample_f`` and divides at the call site — same math).
    """
    k = mat.kind[..., None]

    # ---- Diffuse: cosine-weighted hemisphere; weight = albedo (f*cos/pdf). ----
    from tpu_pt.core.sampling import cosine_hemisphere

    wi_d, _ = cosine_hemisphere(u[..., 0:2])
    # If the viewer is on the back side of the shading normal, flip the
    # sampled hemisphere so diffuse reflection stays on the viewer's side.
    flip = jnp.where(wo[..., 2:3] < 0.0, -1.0, 1.0)
    wi_d = wi_d * jnp.concatenate([jnp.ones_like(flip), jnp.ones_like(flip), flip], -1)
    w_d = mat.albedo

    # ---- Mirror: wi = reflect(wo); weight = albedo (f = albedo/|cos| * delta). ----
    wi_m = jnp.concatenate([-wo[..., 0:1], -wo[..., 1:2], wo[..., 2:3]], axis=-1)
    w_m = mat.albedo

    # ---- Glass: Fresnel-weighted choice between reflection and refraction. ----
    wi_t, tir, eta = _refract(wo, mat.ior)
    cos_i = jnp.abs(wo[..., 2:3])
    fresnel = jnp.where(tir, 1.0, _schlick(cos_i, mat.ior))
    take_refl = (u[..., 2:3] < fresnel) | tir
    wi_g = jnp.where(take_refl, wi_m, wi_t)
    # Choosing the lobe with probability equal to its Fresnel weight cancels
    # it: weight = albedo either way; refraction carries the eta^2 radiance
    # compression (PBRT radiance convention).
    w_g = jnp.where(take_refl, mat.albedo, mat.albedo * (eta * eta))

    # ---- Pure refraction: always refract; black on TIR (reference
    # RefractionBSDF). ----
    wi_r = wi_t
    w_r = jnp.where(tir, 0.0, mat.albedo * (eta * eta))

    # ---- GGX glossy: sample the half-vector from the NDF (detached alpha —
    # the sampling DECISION is not differentiated; the integrand f is, so
    # roughness gradients flow through ``weight`` via _ggx_f). ----
    alpha_d = jax.lax.stop_gradient(_ggx_alpha(mat.roughness))
    a2_d = alpha_d * alpha_d
    u0 = u[..., 0:1]
    c2 = (1.0 - u0) / jnp.maximum(1.0 + (a2_d - 1.0) * u0, 1e-12)
    cos_h = jnp.sqrt(jnp.clip(c2, 0.0, 1.0))
    sin_h = jnp.sqrt(jnp.clip(1.0 - c2, 0.0, 1.0))
    phi = 2.0 * jnp.pi * u[..., 1:2]
    # Sample about the normal on the viewer's side (flip like diffuse).
    h = jnp.concatenate(
        [jnp.cos(phi) * sin_h, jnp.sin(phi) * sin_h, cos_h * flip], axis=-1)
    oh = jnp.sum(wo * h, axis=-1, keepdims=True)
    wi_gx = jax.lax.stop_gradient(2.0 * oh * h - wo)
    pdf_h = _ggx_d(cos_h, alpha_d) * cos_h / jnp.maximum(
        4.0 * jnp.abs(oh), 1e-9)
    pdf_h = jax.lax.stop_gradient(pdf_h)
    same_side = (wi_gx[..., 2:3] * flip > 0.0)
    f_gx = _ggx_f(mat, wo * jnp.concatenate(
        [jnp.ones_like(flip), jnp.ones_like(flip), flip], -1),
        wi_gx * jnp.concatenate(
        [jnp.ones_like(flip), jnp.ones_like(flip), flip], -1))
    w_gx = jnp.where(same_side & (pdf_h > 1e-12),
                     f_gx * jnp.abs(wi_gx[..., 2:3]) /
                     jnp.maximum(pdf_h, 1e-12), 0.0)

    wi = jnp.where(k == MAT_DIFFUSE, wi_d,
         jnp.where(k == MAT_MIRROR, wi_m,
         jnp.where(k == MAT_GLASS, wi_g,
         jnp.where(k == MAT_REFRACT, wi_r,
         jnp.where(k == MAT_GGX, wi_gx, wi_d)))))
    weight = jnp.where(k == MAT_DIFFUSE, w_d,
             jnp.where(k == MAT_MIRROR, w_m,
             jnp.where(k == MAT_GLASS, w_g,
             jnp.where(k == MAT_REFRACT, w_r,
             jnp.where(k == MAT_GGX, w_gx, 0.0)))))
    delta = is_delta(mat)
    valid = (k != MAT_EMISSIVE) & (jnp.max(weight, axis=-1, keepdims=True) > 0.0)
    return BsdfSample(wi=wi, weight=weight, delta=delta, valid=valid)
