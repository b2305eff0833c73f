"""Diagnose the backward-pass cost of the differentiable wavefront step.

Times, at BENCH-like sizes on the 1.3M-tri scene (cluster backend):
  fwd-fast   — early-exit while_loop forward (production forward)
  fwd-scan   — fixed-length remat-chunked scan forward (what grad replays)
  grad       — value_and_grad of the same scan (fwd + adjoint sweep)

Run: PYTHONPATH=. python tools/diag_grad.py
Knobs: DIAG_SIZE (default 128), DIAG_QUEUE (default 4096).
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh.cluster import build_cluster_bvh
from tpu_pt.config import RenderConfig
from tpu_pt.diff.adjoint import loss_and_grad_wavefront
from tpu_pt.diff.params import split
from tpu_pt.render.wavefront import n_steps, wavefront_accum
from tpu_pt.scene import meshes


def sync_time(fn, *args, reps=2):
    out = fn(*args)
    jax.tree.map(lambda x: np.asarray(x), out)
    ts = []
    for _ in range(reps):
        t0 = time.time()
        jax.tree.map(lambda x: np.asarray(x), fn(*args))
        ts.append(time.time() - t0)
    return min(ts)


def main():
    size = int(os.environ.get("DIAG_SIZE", "128"))
    queue = int(os.environ.get("DIAG_QUEUE", "4096"))
    scene = meshes.big_scene(subdiv=8)
    cam = meshes.big_camera(size, size)
    cfg = RenderConfig(width=size, height=size, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    bvh = jax.device_put(build_cluster_bvh(scene))
    scene = jax.device_put(scene)
    key = jax.random.key(0)
    Q = min(queue, cfg.n_pixels)
    steps = n_steps(cfg, Q)
    print(f"size={size} queue={Q} steps={steps} "
          f"device={jax.devices()[0]}")

    f_fast = jax.jit(lambda k: wavefront_accum(
        scene, cam, cfg, k, bvh, queue, "cluster", 0, cfg.n_pixels,
        fast=True))
    print(f"fwd-fast : {sync_time(f_fast, key):7.3f} s")

    f_scan = jax.jit(lambda k: wavefront_accum(
        scene, cam, cfg, k, bvh, queue, "cluster", 0, cfg.n_pixels,
        fast=False))
    print(f"fwd-scan : {sync_time(f_scan, key):7.3f} s")

    params, _ = split(scene)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)

    def g(k):
        return loss_and_grad_wavefront(params, scene, cam, cfg, k, target,
                                       bvh, backend="cluster", queue=queue)

    print(f"grad     : {sync_time(g, key):7.3f} s")


if __name__ == "__main__":
    main()
