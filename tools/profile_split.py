"""Split-factor sweep for intra-step traversal batch splitting.

Where the traversal is SUB-LINEAR in queue width (profile_overlap.py),
independent narrower sub-batches beat one wide batch — cheaper narrow
sorts/intermediates and XLA interleaving.  This sweeps the split factor
for both traversal kinds to pick the production setting.

Run: PYTHONPATH=. python tools/profile_split.py
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as C
from tpu_pt.scene import meshes


def timed_loop(stage, ro, rd, iters):
    @jax.jit
    def run(ro, rd):
        def body(carry, i):
            acc, ro_i = carry
            out = stage(ro_i, rd)
            ro_n = ro_i + (out * 1e-12 + 1e-9)
            return (acc + out, ro_n), None

        (acc, _), _ = jax.lax.scan(body, (jnp.float32(0.0), ro),
                                   jnp.arange(iters))
        return acc

    run(ro, rd)
    float(np.asarray(run(ro, rd)))
    ts = []
    for _ in range(3):
        t0 = time.time()
        float(np.asarray(run(ro, rd)))
        ts.append(time.time() - t0)
    return min(ts) / iters


def main():
    from tpu_pt.cli import enable_compile_cache

    enable_compile_cache()
    Q = int(os.environ.get("PROF_QUEUE", "4096"))
    iters = int(os.environ.get("PROF_ITERS", "50"))
    scene = meshes.big_scene(subdiv=8)
    cam = meshes.big_camera(1024, 1024)
    cb = C.build_cluster_bvh(scene)
    print(f"tris={scene.n_tris} clusters={cb.n_clusters} Q={Q}")
    cb_d = jax.device_put(cb)

    from tpu_pt.core.camera import generate_rays, pixel_xy

    k1 = jax.random.key(0)
    pix = jax.random.randint(k1, (Q,), 0, 1024 * 1024)
    xy = pixel_xy(1024, 1024, pix, jnp.full((Q, 2), 0.5))
    ro, rd = generate_rays(cam, xy)
    ro = jax.device_put(jnp.asarray(ro, jnp.float32))
    rd = jax.device_put(jnp.asarray(rd, jnp.float32))

    def closest_split(ro_, rd_, k):
        h = Q // k
        acc = jnp.float32(0.0)
        for i in range(k):
            tmin = jnp.zeros((h, 1), jnp.float32)
            tmax = jnp.full((h, 1), 1e30, jnp.float32)
            bt, g, u, v, _ = C._traverse_compact(
                cb_d, ro_[i * h:(i + 1) * h], rd_[i * h:(i + 1) * h] + i * 1e-9,
                tmin, tmax)
            acc = acc + jnp.sum(jnp.where(bt < C.INF, bt, 0.0))
        return acc

    def anyhit_split(ro_, rd_, k):
        h = Q // k
        acc = jnp.float32(0.0)
        for i in range(k):
            tmin = jnp.zeros((h, 1), jnp.float32)
            tmax = jnp.full((h, 1), 1e30, jnp.float32)
            occ, _ = C._traverse_compact_anyhit(
                cb_d, ro_[i * h:(i + 1) * h], rd_[i * h:(i + 1) * h] + i * 1e-9,
                tmin, tmax)
            acc = acc + jnp.sum(occ.astype(jnp.float32))
        return acc

    for k in (1, 2, 4, 8):
        dt = timed_loop(lambda ro_, rd_, k=k: closest_split(ro_, rd_, k),
                        ro, rd, iters)
        print(f"closest split={k}: {dt*1e3:8.3f} ms")
    for k in (1, 2, 4):
        dt = timed_loop(lambda ro_, rd_, k=k: anyhit_split(ro_, rd_, k),
                        ro, rd, iters)
        print(f"anyhit  split={k}: {dt*1e3:8.3f} ms")


if __name__ == "__main__":
    main()
