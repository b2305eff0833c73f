"""Attribute capacity-contract overflow on the REAL bench wavefront.

When a render overflows, the scalar overflow counter cannot say WHERE (which descent level / the flat pair budget) or
WHEN (which steps / bounce depths).  This tool replays the real
`wavefront._step` loop on the bench config with stat-collecting
intersectors: every step records, per source (closest-hit vs shadow), the
per-level descent truncations, the flat-pair-budget drops, the MAX per-ray
candidate width each level actually needed, and the total live pair count —
the data that sizes the capacity contract from the true mixed-depth
population instead of the camera+random proxy (VERDICT r3 task 1a/1b).

Run: PYTHONPATH=. python tools/attribute_overflow.py
Knobs: AO_QUEUE (4096), AO_STEPS (500), AO_SIZE (1024), AO_SCENE (big-1m),
       AO_AUTOTUNE=1 (attribute the autotuned BVH instead of defaults).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as C
from tpu_pt.config import RenderConfig
from tpu_pt.render import wavefront as W
from tpu_pt.scene import meshes


def make_stat_fns(cb, n_sources=2):
    """intersect/occluded with overflow ATTRIBUTION.  The overflow return is
    a (2L+2, n_sources) f32 matrix instead of a scalar — column 0 filled by
    the closest-hit call, column 1 by the shadow call, so `_step`'s
    `n_ovf + ovf_s` sum keeps the sources separate.  Rows:
    [0..L)    descent truncations per level (sum over rays)
    [L]       flat-pair-budget drops
    [L+1..2L+1) MAX per-ray candidate width needed at each level
    [2L+1]    total live pairs entering the flat pair stage."""
    L = len(cb.levels)

    def stats_for(ro, rd, t_min1, t_max1, col):
        collect = []
        cand, live, _ = C._descend_compact(
            cb, ro, 1.0 / rd, t_min1[:, None], t_max1[:, None],
            collect=collect)
        Q = ro.shape[0]
        budget = int(cb.pair_mults[2] * Q)
        rayP, _, dropped, _, _ = C._flat_pairs(cand, live, Q, budget)
        vec = jnp.zeros((2 * L + 2,), jnp.float32)
        for l, (needed, trunc) in enumerate(collect):
            vec = vec.at[l].set(jnp.sum(trunc).astype(jnp.float32))
            vec = vec.at[L + 1 + l].set(jnp.max(needed).astype(jnp.float32))
        vec = vec.at[L].set(dropped.astype(jnp.float32))
        vec = vec.at[2 * L + 1].set(
            jnp.sum((rayP < Q)).astype(jnp.float32))
        out = jnp.zeros((2 * L + 2, n_sources), jnp.float32)
        return out.at[:, col].set(vec)

    def isect(scene, ro, rd, t_min, t_max):
        hit, _ = C.intersect_counted(cb, scene, ro, rd, t_min, t_max)
        return hit, stats_for(ro, rd, t_min[:, 0], t_max[:, 0], 0)

    def occl(scene, ro, rd, t_max, narrow=False):
        del narrow  # attribution probes always use the wide budget
        occ, _ = C.occluded_counted(cb, scene, ro, rd, t_max)
        t_max_b = jnp.broadcast_to(t_max, (ro.shape[0], 1))
        return occ, stats_for(ro, rd, jnp.zeros((ro.shape[0],)),
                              t_max_b[:, 0], 1)

    return isect, occl


def main():
    Q = int(os.environ.get("AO_QUEUE", "4096"))
    steps = int(os.environ.get("AO_STEPS", "500"))
    size = int(os.environ.get("AO_SIZE", "1024"))
    scene_name = os.environ.get("AO_SCENE", "big-1m")
    if scene_name == "atrium":
        scene = meshes.atrium_scene()
        cam = meshes.atrium_camera(size, size)
    else:
        subdiv = {"big": 7, "big-1m": 8}[scene_name]
        scene = meshes.big_scene(subdiv=subdiv)
        cam = meshes.big_camera(size, size)
    cfg = RenderConfig(width=size, height=size, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    if os.environ.get("AO_AUTOTUNE"):
        cb = C.autotune_for_camera(scene, cam, size, size)
    else:
        cb = C.build_cluster_bvh(scene)
    print(f"frontiers={cb.frontiers} k_leaf={cb.k_leaf} "
          f"pair_mults={cb.pair_mults} C={cb.n_clusters}")
    assert scene.lights.count * cfg.ns_area_light == 1, (
        "stat columns assume exactly one occluded call per step")
    scene_d = jax.device_put(scene)
    cb_d = jax.device_put(cb)
    key = jax.random.key(0)
    isect, occl = make_stat_fns(cb_d)
    L = len(cb.levels)

    n_pix = cfg.n_pixels
    st = W.init_queue(Q, n_pix)

    @jax.jit
    def run(st):
        def body(s, _):
            s, (nc, ns, ovf) = W._step(
                scene_d, cam, cfg, key, isect, occl, s, jnp.int32(0),
                n_pix, jnp.int32(0), cfg.spp)
            return s, (nc, ovf)
        return jax.lax.scan(body, st, None, length=steps)

    _, (nc, ovf) = run(st)
    ovf = np.asarray(ovf)          # (steps, 2L+2, 2)
    nc = np.asarray(nc)
    names = [f"descent L{l}(cap={c})" for l, c in
             enumerate(cb.frontiers[:-1])] + [
        f"descent leaf(k_leaf={cb.k_leaf})"]
    print(f"steps with any live rays: {(nc > 0).sum()} / {steps}")
    for col, src in ((0, "closest"), (1, "shadow ")):
        print(f"--- source: {src}")
        for l in range(L):
            tr = ovf[:, l, col]
            nd = ovf[:, L + 1 + l, col]
            print(f"  {names[l]:26s} truncated {tr.sum():9.0f}  "
                  f"steps>0 {(tr > 0).sum():4d}  "
                  f"max-needed {nd.max():6.0f}  p99-step-need "
                  f"{np.percentile(nd[nc[:] > 0], 99):6.0f}")
        pd = ovf[:, L, col]
        pl = ovf[:, 2 * L + 1, col]
        print(f"  pair budget ({cb.pair_mults[2]}*Q={cb.pair_mults[2]*Q})"
              f"   dropped {pd.sum():9.0f}  steps>0 {(pd > 0).sum():4d}  "
              f"max-live {pl.max():7.0f}  p99 "
              f"{np.percentile(pl[nc[:] > 0], 99):7.0f}")
    # Which steps overflowed (early camera-coherent vs mixed-depth tail)?
    any_ovf = ovf[:, :L + 1, :].sum(axis=(1, 2))
    bad = np.flatnonzero(any_ovf > 0)
    if len(bad):
        print(f"overflowing steps: n={len(bad)} first={bad[0]} "
              f"last={bad[-1]}  worst_step={any_ovf.argmax()} "
              f"({any_ovf.max():.0f} cands)")
    else:
        print("no overflow anywhere")


if __name__ == "__main__":
    main()
