"""Stackless BVH traversal over the flat skip-pointer layout (XLA path).

Batched counterpart of the reference's ``BVHAccel::intersect`` recursive
walk and the CUDA kernel's iterative stack traversal (SURVEY.md §2 rows 9,
14).  Every ray carries a single node cursor; all rays advance in lockstep
inside one ``lax.while_loop`` whose body is: gather node → AABB slab test →
(leaf? test ≤ MAX_LEAF primitives) → advance cursor to i+1 (hit inner) or
skip[i] (miss / after leaf).  Terminated lanes idle at cursor == N until the
slowest lane finishes — the wavefront renderer compacts those away between
bounces (SURVEY.md §2 "Parallelism strategies").

Tests compare its nearest hits against render/brute.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_pt.bvh.sah import MAX_LEAF, FlatBVH
from tpu_pt.core.aabb import slab_test
from tpu_pt.core.intersect import INF, ray_sphere, ray_triangle
from tpu_pt.render.brute import Hit
from tpu_pt.scene.types import Scene


def _prim_test(scene: Scene, prim_id, active, ro, rd, t_min, t_max):
    """Test one (per-lane) primitive id: triangle or sphere by id range.
    prim_id: (R,) int32; active: (R,1) bool.  Returns (hit, t, u, v)."""
    n_tris = scene.n_tris
    is_tri = prim_id < n_tris
    tri_id = jnp.clip(jnp.where(is_tri, prim_id, 0), 0, n_tris - 1)
    sph_id = jnp.clip(jnp.where(is_tri, 0, prim_id - n_tris), 0, scene.n_spheres - 1)

    idx = scene.tri_idx[tri_id]
    v0 = scene.vertices[idx[:, 0]]
    e1 = scene.vertices[idx[:, 1]] - v0
    e2 = scene.vertices[idx[:, 2]] - v0
    h_t, t_t, u_t, v_t = ray_triangle(ro, rd, v0, e1, e2, t_min, t_max)

    c = scene.sph_center[sph_id]
    r = scene.sph_radius[sph_id][:, None]
    h_s, t_s, _ = ray_sphere(ro, rd, c, r, t_min, t_max)

    is_tri_c = is_tri[:, None]
    hit = active & jnp.where(is_tri_c, h_t, h_s)
    t = jnp.where(is_tri_c, t_t, t_s)
    return hit, jnp.where(hit, t, INF), jnp.where(is_tri_c, u_t, 0.0), jnp.where(is_tri_c, v_t, 0.0)


def intersect(bvh: FlatBVH, scene: Scene, ro, rd, t_min, t_max) -> Hit:
    """Nearest-hit traversal.  ro/rd (R,3); t_min/t_max (R,1) -> Hit."""
    # Host builders produce numpy-leaf pytrees; promote for traced indexing.
    bvh = jax.tree.map(jnp.asarray, bvh)
    scene = jax.tree.map(jnp.asarray, scene)
    R = ro.shape[0]
    n_nodes = bvh.n_nodes
    rd_inv = 1.0 / rd  # ±inf where a component is 0 — slab_test guards nans

    def cond(state):
        cursor, *_ = state
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, best_t, best_prim, best_u, best_v = state
        active = cursor < n_nodes
        node = jnp.where(active, cursor, 0)
        bb_min = bvh.node_min[node]
        bb_max = bvh.node_max[node]
        hit_bb, _ = slab_test(ro, rd_inv, bb_min, bb_max, t_min, best_t)
        hit_bb = hit_bb & active[:, None]
        count = bvh.prim_count[node]
        is_leaf = count > 0
        start = bvh.prim_start[node]

        test_leaf = hit_bb[:, 0] & is_leaf
        for k in range(MAX_LEAF):
            in_range = test_leaf & (k < count)
            slot = jnp.clip(start + k, 0, bvh.prim_ids.shape[0] - 1)
            prim = bvh.prim_ids[slot]
            h, t, u, v = _prim_test(
                scene, prim, in_range[:, None], ro, rd, t_min, best_t
            )
            # Lowest-gid wins at equal t (SURVEY.md §4 item 2 tie rule).
            closer = h & ((t < best_t)
                          | ((t == best_t) & (t < INF)
                             & (prim < best_prim)[:, None]))
            best_prim = jnp.where(closer[:, 0], prim, best_prim)
            best_u = jnp.where(closer, u, best_u)
            best_v = jnp.where(closer, v, best_v)
            best_t = jnp.where(closer, t, best_t)

        descend = hit_bb[:, 0] & ~is_leaf
        nxt = jnp.where(descend, cursor + 1, bvh.skip[node])
        nxt = jnp.where(active, nxt, n_nodes)
        return nxt, best_t, best_prim, best_u, best_v

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.broadcast_to(t_max, (R, 1)).astype(jnp.float32),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R, 1), jnp.float32),
        jnp.zeros((R, 1), jnp.float32),
    )
    _, best_t, best_prim, best_u, best_v = jax.lax.while_loop(cond, body, init)
    found = best_t < jnp.broadcast_to(t_max, (R, 1))
    return Hit(
        hit=found,
        t=jnp.where(found, best_t, INF),
        prim=best_prim,
        u=best_u,
        v=best_v,
    )


def occluded(bvh: FlatBVH, scene: Scene, ro, rd, t_max):
    """Any-hit shadow query: terminates a lane on its first hit.  (R,1) bool."""
    bvh = jax.tree.map(jnp.asarray, bvh)
    scene = jax.tree.map(jnp.asarray, scene)
    R = ro.shape[0]
    n_nodes = bvh.n_nodes
    t_min = jnp.zeros((R, 1), jnp.float32)
    rd_inv = 1.0 / rd

    def cond(state):
        cursor, _ = state
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, occ = state
        active = cursor < n_nodes
        node = jnp.where(active, cursor, 0)
        hit_bb, _ = slab_test(
            ro, rd_inv, bvh.node_min[node], bvh.node_max[node], t_min, t_max
        )
        hit_bb = hit_bb & active[:, None]
        count = bvh.prim_count[node]
        is_leaf = count > 0
        start = bvh.prim_start[node]
        any_hit = jnp.zeros((R,), bool)
        test_leaf = hit_bb[:, 0] & is_leaf
        for k in range(MAX_LEAF):
            in_range = test_leaf & (k < count)
            slot = jnp.clip(start + k, 0, bvh.prim_ids.shape[0] - 1)
            prim = bvh.prim_ids[slot]
            h, _, _, _ = _prim_test(
                scene, prim, in_range[:, None], ro, rd, t_min, t_max
            )
            any_hit = any_hit | h[:, 0]
        occ = occ | any_hit[:, None]
        descend = hit_bb[:, 0] & ~is_leaf
        nxt = jnp.where(descend, cursor + 1, bvh.skip[node])
        nxt = jnp.where(active & ~occ[:, 0], nxt, n_nodes)
        return nxt, occ

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.zeros((R,), jnp.int32), jnp.zeros((R, 1), bool))
    )
    return occ
