"""Ablate the differentiable wavefront step to find the backward bottleneck.

Remat should make the grad pass cost ~3x the forward.  This measures, on
the GPU at the BENCH_GRAD config (big-1m, 256^2, q4096):

  A. forward fast=True   (early-exit while_loop)     — production forward
  B. forward fast=False  (remat chunked scan, no AD) — scan/remat structure
  C. grad, geometry detached (albedo/emission/light only)
  D. grad, full params

If C ~ D, the vertex/normal scatter-adds are NOT the problem and the cost is
in the chunked-scan adjoint structure itself; if B is already slow, it's the
scan (no early exit + chunk padding), not AD at all.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.config import RenderConfig
from tpu_pt.diff.params import merge, split
from tpu_pt.render.wavefront import n_steps, render_wavefront_counts, wavefront_accum
from tpu_pt.scene import meshes

SIZE = 256
QUEUE = 4096


def main():
    scene = meshes.big_scene(subdiv=8)
    cam = meshes.big_camera(SIZE, SIZE)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    from tpu_pt.bvh.cluster import build_cluster_bvh

    packed = build_cluster_bvh(scene)
    scene_d = jax.device_put(scene)
    packed_d = jax.device_put(packed)
    key = jax.random.key(0)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    steps = n_steps(cfg, QUEUE)
    print(f"steps bound = {steps}")

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        jax.tree.map(lambda x: np.asarray(x).ravel()[:1], out)  # sync by fetching
        t_c = time.time() - t0
        t0 = time.time()
        out = fn(*args)
        jax.tree.map(lambda x: np.asarray(x).ravel()[:1], out)
        dt = time.time() - t0
        print(f"{name:38s} run {dt:7.2f}s  (compile+run {t_c:.1f}s)")
        return dt

    import os
    if not os.environ.get("ABLATE_GRAD_ONLY"):
        # A. forward fast
        fwd_fast = jax.jit(lambda k: render_wavefront_counts(
            scene_d, cam, cfg, k, packed_d, queue=QUEUE, backend="cluster"))
        timed("A fwd fast (while_loop)", fwd_fast, key)

        # B. forward scan (remat chunks), no AD
        fwd_scan = jax.jit(lambda k: wavefront_accum(
            scene_d, cam, cfg, k, packed_d, QUEUE, "cluster", 0,
            cfg.n_pixels, fast=False))
        timed("B fwd scan fast=False (no grad)", fwd_scan, key)

    params, _ = split(scene_d)

    def make_grad(detach_geom: bool):
        def loss_fn(p):
            sc = merge(p, scene_d)
            if detach_geom:
                sc = sc._replace(
                    vertices=jax.lax.stop_gradient(sc.vertices),
                    normals=jax.lax.stop_gradient(sc.normals))
            accum = wavefront_accum(sc, cam, cfg, key, packed_d, QUEUE,
                                    "cluster", 0, cfg.n_pixels)
            return jnp.mean((accum / cfg.spp - target) ** 2)

        return jax.jit(jax.value_and_grad(loss_fn))

    timed("C grad, geometry detached", make_grad(True), params)
    timed("D grad, full params", make_grad(False), params)


if __name__ == "__main__":
    main()
