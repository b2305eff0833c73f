"""Differentiable rendering: detached-sampling reparameterized gradients.

The reference renderer is NOT differentiable; this subsystem is the
capability BASELINE.json adds on top (north star: "Differentiate radiance
w.r.t. vertex positions, BRDF albedo/roughness, and light emission via
detached-sampling reparameterized gradients").

Estimator scope (SURVEY.md §7 hard-part 4 — documented precisely):
  - All Monte-Carlo *sampling decisions* (sub-pixel jitter, light-surface
    points' uniforms, BSDF lobe choices and directions, Russian roulette)
    are DETACHED (stop_gradient) — the integrand is differentiated, the
    sampler is not.  This yields unbiased gradients of expected radiance for
    all parameter dependence that is continuous in the integrand:
      * albedo / roughness / emission / light radiance — fully covered;
      * vertex positions — covered through the reparameterized hit point
        p(V) = (1-u-v)·v0 + u·v1 + v·v2 (barycentrics detached), shading
        normals, light-sample geometry, and BSDF shading;
  - Visibility/silhouette discontinuities are NOT differentiated (no edge
    sampling): gradients flow through shading geometry, not through
    occlusion boundaries.  Finite-difference tests (tests/test_diff.py)
    therefore use scenes where the perturbation does not move a silhouette
    across a sample.

The forward pass here reuses the SAME integrator as every other backend,
so "pixel-grad allclose vs reference" reduces to finite differences of the
oracle render itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_pt.config import RenderConfig
from tpu_pt.diff.params import merge
from tpu_pt.render.driver import _intersectors
from tpu_pt.render.integrator import render_chunk
from tpu_pt.scene.types import Scene


def render_flat(scene: Scene, cam, cfg: RenderConfig, key, backend="brute",
                bvh=None):
    """Differentiable whole-image render -> (n_pixels, 3).

    One fused pass (no host chunk loop) so jax.grad can flow; intended for
    the resolutions the differentiable pass uses.  The wavefront renderer is
    also differentiable (scan-based) — this unrolled one keeps the adjoint
    memory at O(max_depth) residual sets, which is cheaper at small sizes.
    """
    isect, occl = _intersectors(backend, bvh)
    pixel_ids = jnp.repeat(jnp.arange(cfg.n_pixels, dtype=jnp.int32), cfg.spp)
    sample_ids = jnp.tile(jnp.arange(cfg.spp, dtype=jnp.int32), cfg.n_pixels)
    L = render_chunk(scene, cam, cfg, key, pixel_ids, sample_ids, isect, occl)
    return L.reshape(cfg.n_pixels, cfg.spp, 3).mean(axis=1)


@functools.partial(jax.jit, static_argnames=("cfg", "backend"))
def render_grad(params, scene: Scene, cam, cfg: RenderConfig, key, grad_image,
                backend: str = "brute", bvh=None):
    """VJP of the renderer: pull a cotangent image back onto the parameters.

    grad_image: (n_pixels, 3) cotangent (e.g. dLoss/dPixel).
    Returns (image, grads) with grads a dict matching ``params``.
    """
    img, vjp_fn = jax.vjp(
        lambda p: render_flat(merge(p, scene), cam, cfg, key, backend, bvh),
        params,
    )
    (grads,) = vjp_fn(grad_image)
    return img, grads


@functools.partial(jax.jit, static_argnames=("cfg", "backend"))
def loss_and_grad(params, scene: Scene, cam, cfg: RenderConfig, key, target,
                  backend: str = "brute", bvh=None):
    """Inverse-rendering step: L2 image loss + parameter gradients.
    target: (n_pixels, 3)."""
    def loss_fn(p):
        img = render_flat(merge(p, scene), cam, cfg, key, backend, bvh)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "backend", "queue", "steps_hint"))
def loss_and_grad_wavefront(params, scene: Scene, cam, cfg: RenderConfig,
                            key, target, bvh, backend: str = "cluster",
                            queue: int = 1 << 14,
                            steps_hint: int | None = None):
    """Differentiable step through the PRODUCTION path (persistent-wavefront
    scan + cluster intersector) on one device — BASELINE config 4 at real
    sizes.  The wavefront scan is √steps-chunk rematerialized
    (render/wavefront.py), so adjoint memory is O((√steps)·queue) and a
    1024² grad render fits on a chip.  target: (n_pixels, 3).

    steps_hint: static cap on the scan length — the differentiable scan
    cannot early-exit, and the worst-case bound pads it 2.8x (459/1285
    steps executed on the big-1m 1024² bench render).
    Callers derive the hint from a counting forward run (+ slack) and MUST
    check the returned ``done`` flag: (loss, grads, done) is returned when
    a hint is given; done=False means the hint was too small and the loss
    dropped samples — redo with the full bound."""
    from tpu_pt.render.wavefront import wavefront_accum

    def loss_fn(p):
        sc = merge(p, scene)
        accum, done = wavefront_accum(sc, cam, cfg, key, bvh, queue,
                                      backend, 0, cfg.n_pixels,
                                      steps_hint=steps_hint, with_done=True)
        img = accum / cfg.spp
        return jnp.mean((img - target) ** 2), done

    (loss, done), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    if steps_hint is not None:
        return loss, grads, done
    return loss, grads
