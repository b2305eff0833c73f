"""Microbenchmark the pair-major descent's components.

Times: 1-D flat pair sorts at the real sizes, the per-level child block
gathers, the per-pair ray gathers, and the three descent levels in
isolation — to find where _descend_pairs' time goes.

Run: PYTHONPATH=. python tools/microbench_pairs.py
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as C
from tpu_pt.scene import meshes
from tpu_pt.core.camera import generate_rays, pixel_xy


def timed_loop(fn, args, iters=50):
    @jax.jit
    def run(*args):
        def body(carry, _):
            acc, a0 = carry
            out = fn(a0, *args[1:])
            a0 = a0 + out * 1e-12
            return (acc + out, a0), None

        (acc, _), _ = jax.lax.scan(body, (jnp.float32(0.0), args[0]),
                                   jnp.arange(iters))
        return acc

    run(*args)
    float(np.asarray(run(*args)))
    ts = []
    for _ in range(3):
        t0 = time.time()
        float(np.asarray(run(*args)))
        ts.append(time.time() - t0)
    return min(ts) / iters


def main():
    Q = 4096
    scene = meshes.big_scene(subdiv=8)
    cam = meshes.big_camera(1024, 1024)
    cb = jax.tree.map(jnp.asarray, C.build_cluster_bvh(scene))

    k1 = jax.random.key(0)
    pix = jax.random.randint(k1, (Q,), 0, 1024 * 1024)
    xy = pixel_xy(1024, 1024, pix, jnp.full((Q, 2), 0.5))
    ro, rd = generate_rays(cam, xy)
    ro = jnp.asarray(ro, jnp.float32)
    rd = jnp.asarray(rd, jnp.float32)
    t_min1 = jnp.zeros((Q,), jnp.float32)
    t_max1 = jnp.full((Q,), 1e30, jnp.float32)

    # --- 1-D flat sorts (2 x i32 operands) at the real sizes.
    for M in (94208, 262144, 954368):
        key = jax.random.randint(k1, (M,), 0, Q + 1, dtype=jnp.int32)
        pay = jnp.arange(M, dtype=jnp.int32)

        def s_sort(keyf, pay=pay):
            k, p = jax.lax.sort((keyf.astype(jnp.int32), pay), dimension=0,
                                num_keys=1, is_stable=True)
            return jnp.sum(k[:10].astype(jnp.float32)) * 1e-12

        dt = timed_loop(s_sort, (key.astype(jnp.float32),))
        print(f"1-D stable sort {M:7d} x (i32 key + i32 payload): "
              f"{dt*1e3:7.3f} ms")

    # --- per-pair ray gathers at P=32768.
    P = 32768
    rayP = jax.random.randint(k1, (P,), 0, Q, dtype=jnp.int32)

    def s_raygather(rayPf):
        r = rayPf.astype(jnp.int32)
        return jnp.sum(ro[r][:, 0] + rd[r][:, 0] + t_min1[r] + t_max1[r]) \
            * 1e-12

    dt = timed_loop(s_raygather, (rayP.astype(jnp.float32),))
    print(f"ray gathers (ro/rd/tmin/tmax) at P={P}: {dt*1e3:7.3f} ms")

    # --- child block gather + slab at P=32768 (mid level).
    child = cb.levels[2].reshape(-1, 8, 8)
    nodeP = jax.random.randint(k1, (P,), 0, child.shape[0], dtype=jnp.int32)

    def s_childgather(nodePf):
        blk = child[jnp.clip(nodePf.astype(jnp.int32), 0, child.shape[0] - 1)]
        return jnp.sum(blk[..., 0]) * 1e-12

    dt = timed_loop(s_childgather, (nodeP.astype(jnp.float32),))
    print(f"child block gather (P={P},8,8) from 466KB: {dt*1e3:7.3f} ms")

    # --- full _descend_pairs per level count: hack by rebuilding cb with
    # fewer levels (top-only, top+mid).
    for nlev in (1, 2, 3):
        cb_cut = C.ClusterBVH(cb.levels[:nlev], cb.tiles, cb.tile_gid,
                              cb.frontiers[:nlev], cb.k_leaf, cb.pair_budget,
                              cb.pair_mults)

        def s_desc(ro_i, rd_i, cb_cut=cb_cut):
            rayP, cidP, drop = C._descend_pairs(cb_cut, ro_i, 1.0 / rd_i,
                                                t_min1, t_max1)
            return jnp.sum(rayP.astype(jnp.float32)) * 1e-12

        dt = timed_loop(lambda ro_i, rd_i, f=s_desc: f(ro_i, rd_i), (ro, rd))
        print(f"_descend_pairs with {nlev} level(s): {dt*1e3:7.3f} ms")




def gather_dtype_bench():
    """Is the 256B block gather byte-bound or row-bound?  bf16 vs f32 vs
    fused-upcast, plus one-big-row layouts."""
    import ml_dtypes  # noqa
    Q = 4096
    k = jax.random.key(3)
    for rows, F in ((1864, 23), (14912, 38)):
        table = jax.random.uniform(k, (rows // 8, 8, 8), jnp.float32)
        t16 = table.astype(jnp.bfloat16)
        idx = jax.random.randint(k, (Q, F), 0, rows // 8, dtype=jnp.int32)

        def g32(i):
            return jnp.sum(table[i.astype(jnp.int32)][..., 0]) * 1e-12

        def g16(i):
            blk = t16[i.astype(jnp.int32)].astype(jnp.float32)
            return jnp.sum(blk[..., 0]) * 1e-12

        # flat (64,) f32 rows instead of (8,8)
        tflat = table.reshape(rows // 8, 64)

        def gflat(i):
            return jnp.sum(tflat[i.astype(jnp.int32)][..., 0]) * 1e-12

        for name, fn in (("f32 (8,8)", g32), ("bf16 (8,8)", g16),
                         ("f32 (64,)", gflat)):
            dt = timed_loop(lambda i, f=fn: f(i), (idx.astype(jnp.float32),))
            print(f"gather (Q,{F}) from {rows} rows {name}: {dt*1e3:7.3f} ms")


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "gather":
        gather_dtype_bench()
    else:
        main()
