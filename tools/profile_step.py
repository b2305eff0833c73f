"""Ablation timing of ONE wavefront step on the bench scene.

The stage-level profiler (profile_stages.py) times traversal pieces in
isolation; XLA overlaps them differently inside the fused step, so this
tool times the REAL `_step` (and ablated variants) in a 50-iteration scan
from a realistic mixed-depth queue state.

Run: PYTHONPATH=. python tools/profile_step.py
Knobs: PS_QUEUE (4096), PS_ITERS (50), PS_SCENE (big-1m).
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as C
from tpu_pt.config import RenderConfig
from tpu_pt.render import wavefront as W
from tpu_pt.render.driver import _intersectors_counted
from tpu_pt.scene import meshes


def main():
    Q = int(os.environ.get("PS_QUEUE", "4096"))
    iters = int(os.environ.get("PS_ITERS", "50"))
    scene_name = os.environ.get("PS_SCENE", "big-1m")
    subdiv = {"big": 7, "big-1m": 8}[scene_name]
    scene = meshes.big_scene(subdiv=subdiv)
    cam = meshes.big_camera(1024, 1024)
    cfg = RenderConfig(width=1024, height=1024, spp=1, max_depth=4)
    cb = C.build_cluster_bvh(scene)
    scene_d = jax.device_put(scene)
    cb_d = jax.device_put(cb)
    key = jax.random.key(0)
    intersect_fn, occluded_fn = _intersectors_counted("cluster", cb_d)

    n_pix = cfg.n_pixels
    st = W.init_queue(Q, n_pix)

    def step(st):
        return W._step(scene_d, cam, cfg, key, intersect_fn, occluded_fn,
                       st, jnp.int32(0), n_pix, jnp.int32(0), cfg.spp)

    # Warm the queue into a realistic mixed-depth steady state.
    warm = jax.jit(lambda st: jax.lax.scan(
        lambda s, _: step(s), st, None, length=8)[0])
    st = jax.block_until_ready(warm(st))
    occ = float(np.asarray(jnp.mean(st.alive.astype(jnp.float32))))
    print(f"steady-state occupancy after warmup: {occ:.3f}")

    def timed(body, tag):
        @jax.jit
        def run(st):
            def f(s, _):
                return body(s), None
            s, _ = jax.lax.scan(f, st, None, length=iters)
            return s
        run(st)
        jax.block_until_ready(run(st))
        ts = []
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(run(st))
            ts.append(time.time() - t0)
        print(f"{tag}: {min(ts)/iters*1e3:8.3f} ms/step")
        return min(ts) / iters

    # A. the real step
    timed(lambda s: step(s)[0], "A full step            ")

    # B. the accumulator scatter alone (cheaper to time in isolation than
    # to ablate it out of the fused step).
    def scatter_only(s):
        pix = jnp.maximum(s.ray_id, 0) // cfg.spp
        acc = s.accum.at[pix].add(s.beta, mode="drop")
        return s._replace(accum=acc)

    timed(scatter_only, "B accum scatter only    ")

    # C. respawn only
    timed(lambda s: W._respawn(cam, cfg, key, s, jnp.int32(0), n_pix,
                               jnp.int32(0), cfg.spp),
          "C respawn only          ")

    # D/E from the RESPAWNED state: the in-step traversals run right after
    # respawn at ~full occupancy — profiling them from the post-step state
    # (~20% alive; dead lanes spawn no candidate work) understates them
    # several-fold.
    def respawned(s):
        return W._respawn(cam, cfg, key, s, jnp.int32(0), n_pix,
                          jnp.int32(0), cfg.spp)

    def closest_only(s):
        s = respawned(s)
        t_min = jnp.zeros((Q, 1), jnp.float32)
        t_max = jnp.where(s.alive, 1e30, -1.0)
        hit, _ = intersect_fn(scene_d, s.ro, s.rd, t_min, t_max)
        return s._replace(beta=s.beta + hit.t * 1e-20)

    timed(closest_only, "D respawn+closest       ")

    # E. occlusion traversal only (shadow rays approximated by the same
    # origins at full occupancy; real shadow batches are ~60% live).
    def occl_only(s):
        s = respawned(s)
        occ, _ = occluded_fn(scene_d, s.ro, s.rd,
                             jnp.where(s.alive[:, 0], 10.0, -1.0)[:, None])
        return s._replace(beta=s.beta + occ.astype(jnp.float32) * 1e-20)

    timed(occl_only, "E respawn+occluded      ")

    # F. D+E back to back (how XLA schedules two full descents)
    def both(s):
        s = respawned(s)
        t_min = jnp.zeros((Q, 1), jnp.float32)
        t_max = jnp.where(s.alive, 1e30, -1.0)
        hit, _ = intersect_fn(scene_d, s.ro, s.rd, t_min, t_max)
        occ, _ = occluded_fn(scene_d, s.ro, s.rd,
                             jnp.where(s.alive[:, 0], 10.0, -1.0)[:, None])
        return s._replace(beta=s.beta + hit.t * 1e-20
                          + occ.astype(jnp.float32) * 1e-20)

    timed(both, "F respawn+closest+occl  ")

    # G. ONE fused (2Q,) closest traversal serving both queries (the
    # VERDICT r3 task 2a candidate: occlusion for the shadow half is just
    # best_t < t_max).  Also times the 2Q-shape compile indirectly.
    def fused(s):
        s = respawned(s)
        ro2 = jnp.concatenate([s.ro, s.ro])
        rd2 = jnp.concatenate([s.rd, s.rd])
        t_min2 = jnp.zeros((2 * Q, 1), jnp.float32)
        t_max2 = jnp.concatenate([
            jnp.where(s.alive, 1e30, -1.0),
            jnp.where(s.alive[:, 0], 10.0, -1.0)[:, None]])
        hit, _ = intersect_fn(scene_d, ro2, rd2, t_min2, t_max2)
        return s._replace(beta=s.beta + hit.t[:Q] * 1e-20
                          + (hit.t[Q:] < 10.0) * 1e-20)

    import time as _t
    t0 = _t.time()
    timed(fused, "G fused (2Q) traversal  ")
    print(f"   (G compile+3runs wall: {_t.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
