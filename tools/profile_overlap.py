"""Is the traversal's whole-minus-parts gap overlappable?

When the whole closest traversal takes longer than the sum of its isolated
stages, two competing explanations lead to very different plans:

  (a) fusion-boundary / latency stalls that INDEPENDENT work could fill
      -> split the batch (or pipeline closest+anyhit across wavefront
      steps) and let XLA interleave two independent op chains;
  (b) per-op fixed overhead (dispatch floor x op count)
      -> only fusing stages into fewer ops (a kernel) helps; splitting adds
      ops and should HURT.

This measures, with in-jit scans, data-dependent chaining and scalar-fetch
sync:
  1. traverse_compact at Q (baseline)
  2. traverse_compact at Q/2 (per-ray scaling)
  3. two INDEPENDENT Q/2 traversals per iteration (split-batch overlap)
  4. closest(Q/2) + anyhit(Q/2) independent per iteration (the
     deferred-shadow pipeline proxy: in the restructured wavefront step,
     step k's shadow test runs next to step k+1's closest traversal)
  5. descend_compact(Q) vs 2x descend_compact(Q/2) (descent only)

Run: PYTHONPATH=. python tools/profile_overlap.py
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
    print(f"tris={scene.n_tris} clusters={cb.n_clusters} "
          f"frontiers={cb.frontiers} k_leaf={cb.k_leaf} Q={Q}")
    cb_d = jax.device_put(cb)

    from tpu_pt.core.camera import generate_rays, pixel_xy

    k1 = jax.random.key(0)
    pix = jax.random.randint(k1, (Q,), 0, 1024 * 1024)
    xy = pixel_xy(1024, 1024, pix, jnp.full((Q, 2), 0.5))
    ro, rd = generate_rays(cam, xy)
    ro = jax.device_put(jnp.asarray(ro, jnp.float32))
    rd = jax.device_put(jnp.asarray(rd, jnp.float32))
    H = Q // 2
    t_min = jnp.zeros((Q, 1), jnp.float32)
    t_max = jnp.full((Q, 1), 1e30, jnp.float32)
    t_min_h = t_min[:H]
    t_max_h = t_max[:H]

    def closest(ro_, rd_, tmin, tmax):
        bt, g, u, v, _ = C._traverse_compact(cb_d, ro_, rd_, tmin, tmax)
        return jnp.sum(jnp.where(bt < C.INF, bt, 0.0))

    def anyhit(ro_, rd_, tmin, tmax):
        occ, _ = C._traverse_compact_anyhit(cb_d, ro_, rd_, tmin, tmax)
        return jnp.sum(occ.astype(jnp.float32))

    dt = timed_loop(lambda ro_, rd_: closest(ro_, rd_, t_min, t_max),
                    ro, rd, iters)
    print(f"1. closest Q={Q}:            {dt*1e3:8.3f} ms")

    dt = timed_loop(lambda ro_, rd_: closest(ro_[:H], rd_[:H], t_min_h,
                                             t_max_h), ro, rd, iters)
    print(f"2. closest Q={H}:            {dt*1e3:8.3f} ms")

    def split2(ro_, rd_):
        a = closest(ro_[:H], rd_[:H], t_min_h, t_max_h)
        b = closest(ro_[H:], rd_[H:] + 1e-9, t_min_h, t_max_h)
        return a + b

    dt = timed_loop(split2, ro, rd, iters)
    print(f"3. 2x independent closest {H}: {dt*1e3:8.3f} ms")

    def mixed(ro_, rd_):
        a = closest(ro_[:H], rd_[:H], t_min_h, t_max_h)
        b = anyhit(ro_[H:], rd_[H:] + 1e-9, t_min_h, t_max_h)
        return a + b

    dt = timed_loop(mixed, ro, rd, iters)
    print(f"4. closest {H} + anyhit {H}:  {dt*1e3:8.3f} ms")

    def desc(ro_, rd_, tmin, tmax):
        cand, live, ovf = C._descend_compact(cb_d, ro_, 1.0 / rd_, tmin,
                                             tmax)
        return jnp.sum(live.astype(jnp.float32)) + 1e-9 * jnp.sum(
            cand.astype(jnp.float32))

    dt = timed_loop(lambda ro_, rd_: desc(ro_, rd_, t_min, t_max),
                    ro, rd, iters)
    print(f"5. descend Q={Q}:            {dt*1e3:8.3f} ms")

    def dsplit(ro_, rd_):
        a = desc(ro_[:H], rd_[:H], t_min_h, t_max_h)
        b = desc(ro_[H:], rd_[H:] + 1e-9, t_min_h, t_max_h)
        return a + b

    dt = timed_loop(dsplit, ro, rd, iters)
    print(f"6. 2x independent descend {H}: {dt*1e3:7.3f} ms")


if __name__ == "__main__":
    main()
