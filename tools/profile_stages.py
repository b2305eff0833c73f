"""Per-stage timing of the cluster intersector on the bench scene.

Each stage is looped K times INSIDE one jit (lax.scan with perturbed
inputs), so per-call dispatch latency is amortized.  Reported:
per-iteration ms.  Run: PYTHONPATH=. python tools/profile_stages.py

Knobs: PROF_QUEUE (default 4096), PROF_SCENE (big|big-1m), PROF_ITERS
(default 50).
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as C
from tpu_pt.scene import meshes


def timed_loop(stage, ro, rd, iters):
    """Run ``stage(ro, rd) -> scalar`` iters times inside one jit; returns
    per-iter seconds (sync by scalar fetch)."""

    @jax.jit
    def run(ro, rd):
        def body(carry, i):
            acc, ro_i = carry
            out = stage(ro_i, rd)
            # Data-dependence between iterations prevents CSE/hoisting: the
            # next origin is nudged by a value derived from the output.
            ro_n = ro_i + (out * 1e-12 + 1e-9)
            return (acc + out, ro_n), None

        (acc, _), _ = jax.lax.scan(body, (jnp.float32(0.0), ro),
                                   jnp.arange(iters))
        return acc

    run(ro, rd)  # compile
    float(np.asarray(run(ro, rd)))
    ts = []
    for _ in range(3):
        t0 = time.time()
        float(np.asarray(run(ro, rd)))
        ts.append(time.time() - t0)
    return min(ts) / iters


def main():
    Q = int(os.environ.get("PROF_QUEUE", "4096"))
    iters = int(os.environ.get("PROF_ITERS", "50"))
    scene_name = os.environ.get("PROF_SCENE", "big-1m")
    subdiv = {"big": 7, "big-1m": 8}[scene_name]
    scene = meshes.big_scene(subdiv=subdiv)
    cam = meshes.big_camera(1024, 1024)
    cb = C.build_cluster_bvh(scene)
    print(f"scene={scene_name} tris={scene.n_tris} clusters={cb.n_clusters} "
          f"levels={[lv.shape[0] for lv in cb.levels]} frontiers={cb.frontiers} "
          f"k_leaf={cb.k_leaf} pair_budget={cb.pair_budget} Q={Q} iters={iters}")

    scene_d = jax.device_put(scene)
    cb_d = jax.device_put(cb)

    from tpu_pt.core.camera import generate_rays, pixel_xy

    k1 = jax.random.key(0)
    pix = jax.random.randint(k1, (Q,), 0, 1024 * 1024)
    xy = pixel_xy(1024, 1024, pix, jnp.full((Q, 2), 0.5))
    ro, rd = generate_rays(cam, xy)
    ro = jax.device_put(jnp.asarray(ro, jnp.float32))
    rd = jax.device_put(jnp.asarray(rd, jnp.float32))
    t_min = jnp.zeros((Q, 1), jnp.float32)
    t_max = jnp.full((Q, 1), 1e30, jnp.float32)

    def s_descend(ro, rd):
        cand, cand_t, ovf = C._descend(cb_d, ro, 1.0 / rd, t_min, t_max)
        return jnp.sum(jnp.where(cand_t < C.INF, cand_t, 0.0))

    dt = timed_loop(s_descend, ro, rd, iters)
    print(f"descend (r1):   {dt*1e3:8.3f} ms/iter")

    def s_descend_pairs(ro, rd):
        rayP, cidP, drop = C._descend_pairs(cb_d, ro, 1.0 / rd,
                                            t_min[:, 0], t_max[:, 0])
        return jnp.sum(rayP.astype(jnp.float32)) * 1e-12 + drop.astype(
            jnp.float32)

    dt = timed_loop(s_descend_pairs, ro, rd, iters)
    print(f"descend pairs:  {dt*1e3:8.3f} ms/iter")

    def s_traverse_pairs(ro, rd):
        bt, g, u, v, _ = C._traverse_pairs(cb_d, ro, rd, t_min, t_max)
        return jnp.sum(jnp.where(bt < C.INF, bt, 0.0))

    dt = timed_loop(s_traverse_pairs, ro, rd, iters)
    print(f"traverse pairs: {dt*1e3:8.3f} ms/iter")

    pb = cb.pair_budget
    ray_of = jnp.broadcast_to(jnp.arange(Q, dtype=jnp.int32)[:, None],
                              (Q, pb)).reshape(-1)
    cand, cand_t, _ = jax.jit(
        lambda ro, rd: C._descend(cb_d, ro, 1.0 / rd, t_min, t_max))(ro, rd)
    cid = cand[:, :pb].reshape(-1)
    ok = (cand_t[:, :pb] < C.INF).reshape(-1)

    def s_pairs(ro, rd):
        t_p, u, v, g = C._test_pair_batch(cb_d, ro, rd, t_min[:, 0],
                                          t_max[:, 0], ray_of, cid, ok)
        return jnp.sum(jnp.where(t_p < C.INF, t_p, 0.0))

    dt = timed_loop(s_pairs, ro, rd, iters)
    print(f"pairs rnd1:     {dt*1e3:8.3f} ms/iter  P={Q*pb} "
          f"({Q*pb*6/1024:.0f} MB tiles)")

    def s_traverse(ro, rd):
        bt, g, u, v, _ = C._traverse(cb_d, scene_d, ro, rd, t_min, t_max)
        return jnp.sum(jnp.where(bt < C.INF, bt, 0.0))

    dt = timed_loop(s_traverse, ro, rd, iters)
    print(f"traverse full:  {dt*1e3:8.3f} ms/iter")

    def s_occl(ro, rd):
        occ = C.occluded(cb_d, scene_d, ro, rd, t_max)
        return jnp.sum(occ.astype(jnp.float32))

    dt = timed_loop(s_occl, ro, rd, iters)
    print(f"occluded:       {dt*1e3:8.3f} ms/iter")

    # ---- r2 compact path ----
    def s_descend_compact(ro, rd):
        cand, live, ovf = C._descend_compact(cb_d, ro, 1.0 / rd,
                                             t_min, t_max)
        return jnp.sum(live.astype(jnp.float32)) + 1e-9 * jnp.sum(
            cand.astype(jnp.float32))

    dt = timed_loop(s_descend_compact, ro, rd, iters)
    print(f"descend compact:{dt*1e3:8.3f} ms/iter")

    def s_traverse_compact(ro, rd):
        bt, g, u, v, _ = C._traverse_compact(cb_d, ro, rd, t_min, t_max)
        return jnp.sum(jnp.where(bt < C.INF, bt, 0.0))

    dt = timed_loop(s_traverse_compact, ro, rd, iters)
    print(f"traverse compact:{dt*1e3:7.3f} ms/iter")

    def s_anyhit_compact(ro, rd):
        occ, _ = C._traverse_compact_anyhit(cb_d, ro, rd, t_min, t_max)
        return jnp.sum(occ.astype(jnp.float32))

    dt = timed_loop(s_anyhit_compact, ro, rd, iters)
    print(f"anyhit compact: {dt*1e3:8.3f} ms/iter")

    budget = cb.pair_mults[2] * Q
    cand_c, live_c, _ = jax.jit(
        lambda ro, rd: C._descend_compact(cb_d, ro, 1.0 / rd, t_min,
                                          t_max))(ro, rd)
    rayP, cidP, _, _, _, _ = jax.jit(
        lambda c, l: C._flat_pairs(c, l, Q, budget))(cand_c, live_c)

    def s_flat_pairs(ro, rd):
        rp, cp, d, _, _ = C._flat_pairs(cand_c, live_c, Q, budget)
        return jnp.sum(rp.astype(jnp.float32)) * 1e-9

    dt = timed_loop(s_flat_pairs, ro, rd, iters)
    print(f"flat_pairs sort:{dt*1e3:8.3f} ms/iter  ({Q * cb.k_leaf} keys)")

    def s_pairs_flat(ro, rd):
        t_p, u, v, g = C._test_pair_batch(
            cb_d, ro, rd, t_min[:, 0], t_max[:, 0],
            jnp.minimum(rayP, Q - 1), cidP, rayP < Q)
        return jnp.sum(jnp.where(t_p < C.INF, t_p, 0.0))

    dt = timed_loop(s_pairs_flat, ro, rd, iters)
    print(f"pairs flat:     {dt*1e3:8.3f} ms/iter  P={budget} "
          f"({budget*6/1024:.0f} MB tiles)")

    # Isolated sorts at descent shapes.
    for n in [cb.levels[0].shape[0], cb.frontiers[0] * 8, cb.frontiers[1] * 8]:
        keys0 = jax.random.uniform(jax.random.key(1), (Q, n), jnp.float32)

        def s_sort(ro, rd, keys0=keys0, n=n):
            k = (keys0 + jnp.sum(ro) * 1e-20).astype(jnp.bfloat16)
            vals = jnp.broadcast_to(
                jnp.arange(n, dtype=jnp.int32)[None], (Q, n))
            ks, vs = jax.lax.sort((k, vals), dimension=1, num_keys=1)
            return jnp.sum(ks[:, 0].astype(jnp.float32))

        dt = timed_loop(s_sort, ro, rd, iters)
        print(f"sort (Q,{n:5d}) bf16+i32: {dt*1e3:8.3f} ms/iter")


if __name__ == "__main__":
    main()
