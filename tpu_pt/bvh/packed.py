"""Packed, gather-minimal BVH traversal — the tuned XLA hot path.

The naive flat traversal pays 4 separate node gathers per lockstep
iteration, and a large ray batch needs max-over-lanes iterations far above
the mean.  This module attacks both factors (SURVEY.md §7 hard-part 1, PAPERS.md ray-reordering):

  1. ONE gather per node step: the node is packed into an (N, 8) f32 row
     ``[min.xyz, max.xyz, skip_or_meta, meta]`` (int fields bitcast to f32);
  2. ONE gather per primitive test: triangles are pretransformed to
     ``[v0, e1, e2]`` rows; spheres ride the same (P, 12) table with a type
     flag, so mixed-primitive leaves cost a single row fetch;
  3. octant-ordered skip tables: 8 precomputed DFS orders (children swapped
     so the child nearer along the ray's direction sign is visited first),
     giving early t_max tightening like the reference's ordered recursive
     walk (SURVEY.md §2 row 9) — stackless;
  4. block-wise lockstep: the caller sorts/partitions rays into coherent
     blocks (wavefront sorting) and maps the traversal over blocks, so a
     slow lane only stalls its own block, not the whole queue.

The packed tables are nondifferentiable constants — fine, because hit
results (t, u, v, prim) are detached by design and shading recomputes
geometry from ``scene.vertices`` in-graph (tpu_pt/diff/adjoint.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh.sah import FlatBVH
from tpu_pt.core.intersect import INF
from tpu_pt.render.brute import Hit
from tpu_pt.scene.types import Scene


@jax.tree_util.register_pytree_node_class
class PackedBVH:
    """Pytree whose ``max_leaf`` is STATIC (aux data), so passing a
    PackedBVH as a jit argument keeps table arrays traced (donated/resident,
    never baked in as huge constants) while
    the leaf-unroll count stays a Python int."""

    def __init__(self, table, prim_gid, max_leaf: int, n_tables: int,
                 n_nodes: int):
        # table: (K*N + P, 16) f32 — ONE unified array holding the K
        #   octant-ordered node tables (rows [0, K*N), 16-wide with cols
        #   8..15 zero) followed by the P primitive rows (rows [K*N, K*N+P)).
        #   Node row:  [min.xyz, max.xyz, skip(i32 bits), meta(i32 bits), 0*8]
        #     meta: -1 for inner; else prim_slot_start | (count << 26)
        #   Prim row:  tri    [v0, e1, e2, matf, 0(type), pad]
        #              sphere [center, r, 0,0, 0,0,0, matf, 1(type), pad]
        # WHY unified: one gather per traversal step reads nodes and
        # primitives alike, from a single array.
        # prim_gid: (P,) i32 global primitive id per packed row.
        self.table = table
        self.prim_gid = prim_gid
        self.max_leaf = max_leaf
        self.n_tables = n_tables
        self._n_nodes = n_nodes

    @staticmethod
    def build(nodes, prims, prim_gid, max_leaf: int = 4):
        """Assemble from host numpy parts: nodes (K, N, 8), prims (P, 16)."""
        k, n, _ = nodes.shape
        p = prims.shape[0]
        table = np.zeros((k * n + p, 16), np.float32)
        table[: k * n, :8] = nodes.reshape(k * n, 8)
        table[k * n:] = prims
        return PackedBVH(table=table, prim_gid=prim_gid, max_leaf=max_leaf,
                         n_tables=k, n_nodes=n)

    def tree_flatten(self):
        return (self.table, self.prim_gid), (
            self.max_leaf, self.n_tables, self._n_nodes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, max_leaf=aux[0], n_tables=aux[1],
                   n_nodes=aux[2])

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def prim_base(self) -> int:
        return self.n_tables * self._n_nodes

    @property
    def n_prims(self) -> int:
        return self.prim_gid.shape[0]

    def node_rows(self):
        """(K, N, 8) numpy view of the node tables (tests/introspection)."""
        return np.asarray(self.table[: self.prim_base, :8]).reshape(
            self.n_tables, self._n_nodes, 8
        )


def _subtree_sizes(skip, prim_count):
    """Size (node count) of every subtree in the flat layout, O(N)."""
    n = len(skip)
    size = np.ones(n, np.int64)
    # Children have strictly larger indices; iterate bottom-up.
    for i in range(n - 1, -1, -1):
        if prim_count[i] == 0:
            left = i + 1
            right = skip[left]
            size[i] = 1 + size[left] + size[right]
    return size


def _octant_tables(bvh: FlatBVH):
    """Build the 8 octant-ordered node tables.  Host-side numpy."""
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    skip = np.asarray(bvh.skip)
    start = np.asarray(bvh.prim_start)
    count = np.asarray(bvh.prim_count)
    n = len(skip)
    sizes = _subtree_sizes(skip, count)
    ext = node_max - node_min
    wide_axis = np.argmax(ext, axis=1)
    cent_sum = node_min + node_max  # 2*centroid

    tables = np.empty((8, n, 8), np.float32)
    for octant in range(8):
        sign = (bool(octant & 1), bool(octant & 2), bool(octant & 4))
        perm = np.empty(n, np.int64)
        new_skip = np.empty(n, np.int32)
        cursor = 0
        stack = [(0, n)]
        while stack:
            old, skip_to = stack.pop()
            new = cursor
            cursor += 1
            perm[new] = old
            new_skip[new] = skip_to
            if count[old] > 0:
                continue
            left = old + 1
            right = skip[left]
            axis = wide_axis[old]
            first, second = (
                (left, right)
                if cent_sum[left][axis] <= cent_sum[right][axis]
                else (right, left)
            )
            if sign[axis]:
                first, second = second, first
            stack.append((second, skip_to))
            stack.append((first, new + 1 + sizes[first]))
        t = tables[octant]
        t[:, 0:3] = node_min[perm]
        t[:, 3:6] = node_max[perm]
        t[:, 6] = new_skip.view(np.float32)
        meta = np.where(
            count[perm] > 0,
            (start[perm] | (count[perm] << 26)).astype(np.int32),
            np.int32(-1),
        )
        t[:, 7] = meta.view(np.float32)
    return tables


def pack_bvh(bvh: FlatBVH, scene: Scene, max_leaf: int = 4) -> PackedBVH:
    tables = _octant_tables(bvh)

    # Primitive rows in leaf order (prim_ids permutation).
    pid = np.asarray(bvh.prim_ids)
    v = np.asarray(scene.vertices)
    ti = np.asarray(scene.tri_idx)
    tm = np.asarray(scene.tri_mat)
    sc = np.asarray(scene.sph_center)
    sr = np.asarray(scene.sph_radius)
    sm = np.asarray(scene.sph_mat)
    n_tris = ti.shape[0]
    p = len(pid)
    rows = np.zeros((p, 16), np.float32)
    is_tri = pid < n_tris
    tg = pid[is_tri]
    v0 = v[ti[tg, 0]]
    rows[is_tri, 0:3] = v0
    rows[is_tri, 3:6] = v[ti[tg, 1]] - v0
    rows[is_tri, 6:9] = v[ti[tg, 2]] - v0
    rows[is_tri, 9] = tm[tg].astype(np.int32).view(np.float32)
    sg = pid[~is_tri] - n_tris
    rows[~is_tri, 0:3] = sc[sg]
    rows[~is_tri, 3] = sr[sg]
    rows[~is_tri, 9] = sm[sg].astype(np.int32).view(np.float32)
    rows[~is_tri, 10] = 1.0
    return PackedBVH.build(nodes=tables, prims=rows, prim_gid=pid,
                           max_leaf=max_leaf)


def _prim_row_test(row, active, ro, rd, t_min, t_max):
    """Möller–Trumbore / sphere test against packed rows.  row: (R, 16)."""
    is_sph = row[:, 10:11] > 0.5
    v0 = row[:, 0:3]
    e1 = row[:, 3:6]
    e2 = row[:, 6:9]
    # Triangle (Möller–Trumbore, same math as core.intersect.ray_triangle).
    pvec = jnp.cross(rd, e2)
    det = jnp.sum(e1 * pvec, -1, keepdims=True)
    parallel = jnp.abs(det) < 1e-12
    inv_det = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, det))
    tvec = ro - v0
    u = jnp.sum(tvec * pvec, -1, keepdims=True) * inv_det
    qvec = jnp.cross(tvec, e1)
    vv = jnp.sum(rd * qvec, -1, keepdims=True) * inv_det
    t_tri = jnp.sum(e2 * qvec, -1, keepdims=True) * inv_det
    hit_tri = (~parallel) & (u >= 0) & (vv >= 0) & (u + vv <= 1) \
        & (t_tri >= t_min) & (t_tri <= t_max)
    # Sphere.
    oc = ro - v0
    radius = row[:, 3:4]
    a = jnp.sum(rd * rd, -1, keepdims=True)
    b = 2.0 * jnp.sum(oc * rd, -1, keepdims=True)
    c = jnp.sum(oc * oc, -1, keepdims=True) - radius * radius
    disc = b * b - 4 * a * c
    has = disc >= 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 1.0 / jnp.maximum(2 * a, 1e-20)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    ok0 = has & (t0 >= t_min) & (t0 <= t_max)
    ok1 = has & (t1 >= t_min) & (t1 <= t_max)
    t_sph = jnp.where(ok0, t0, t1)
    hit_sph = ok0 | ok1

    hit = active & jnp.where(is_sph, hit_sph, hit_tri)
    t = jnp.where(is_sph, t_sph, t_tri)
    return hit, jnp.where(hit, t, INF), jnp.where(is_sph, 0.0, u), jnp.where(is_sph, 0.0, vv)


def _octant_of(rd):
    """(R,) int32 octant index from direction signs."""
    return (
        (rd[:, 0] < 0).astype(jnp.int32)
        + 2 * (rd[:, 1] < 0).astype(jnp.int32)
        + 4 * (rd[:, 2] < 0).astype(jnp.int32)
    )


def _traverse(packed: PackedBVH, ro, rd, t_min, t_max, any_hit: bool):
    """Shared traversal core.  Returns Hit (closest) or occlusion flags."""
    packed = jax.tree.map(jnp.asarray, packed)
    R = ro.shape[0]
    n = packed.n_nodes
    rd_inv = 1.0 / rd
    # One unified (K*N + P, 16) table: node rows first (cursor offset by
    # octant*N), prim rows after prim_base.  Single gather per step either
    # way.
    table = packed.table
    prim_base = packed.prim_base
    base = (_octant_of(rd) % packed.n_tables) * n

    max_leaf = packed.max_leaf

    def cond(state):
        return jnp.any(state[0] < n)

    def body(state):
        cursor, best_t, best_gid, best_slot, best_u, best_v, occ = state
        active = (cursor < n) & ~occ[:, 0]
        node = table[base + jnp.where(active, cursor, 0)]
        bb_min = node[:, 0:3]
        bb_max = node[:, 3:6]
        skip = jax.lax.bitcast_convert_type(node[:, 6], jnp.int32)
        meta = jax.lax.bitcast_convert_type(node[:, 7], jnp.int32)
        lo = (bb_min - ro) * rd_inv
        hi = (bb_max - ro) * rd_inv
        near = jnp.minimum(lo, hi)
        far = jnp.maximum(lo, hi)
        near = jnp.where(jnp.isnan(near), -jnp.inf, near)
        far = jnp.where(jnp.isnan(far), jnp.inf, far)
        t_near = jnp.maximum(jnp.max(near, -1, keepdims=True), t_min)
        t_far = jnp.minimum(jnp.min(far, -1, keepdims=True), best_t)
        hit_bb = (t_near <= t_far) & active[:, None]

        is_leaf = meta >= 0
        start = meta & ((1 << 26) - 1)
        cnt = jax.lax.shift_right_logical(meta, 26)
        test_leaf = hit_bb[:, 0] & is_leaf
        for k in range(max_leaf):
            in_rng = test_leaf & (k < cnt)
            slot = jnp.clip(start + k, 0, packed.n_prims - 1)
            row = table[prim_base + slot]
            h, t, u, v = _prim_row_test(
                row, in_rng[:, None], ro, rd, t_min, best_t
            )
            # Lowest-gid tie-break at equal t (SURVEY.md §4 item 2 — every
            # backend must agree exactly, including on coincident prims).
            gid = packed.prim_gid[slot]
            closer = h & ((t < best_t)
                          | ((t == best_t) & (gid < best_gid)[:, None]))
            best_slot = jnp.where(closer[:, 0], slot, best_slot)
            best_gid = jnp.where(closer[:, 0], gid, best_gid)
            best_u = jnp.where(closer, u, best_u)
            best_v = jnp.where(closer, v, best_v)
            best_t = jnp.where(closer, t, best_t)
            if any_hit:
                occ = occ | closer

        descend = hit_bb[:, 0] & ~is_leaf
        nxt = jnp.where(descend, cursor + 1, skip)
        done = ~active
        nxt = jnp.where(done, n, nxt)
        return nxt, best_t, best_gid, best_slot, best_u, best_v, occ

    init = (
        jnp.zeros((R,), jnp.int32),
        jnp.broadcast_to(t_max, (R, 1)).astype(jnp.float32),
        jnp.full((R,), 2**31 - 1, jnp.int32),
        jnp.zeros((R,), jnp.int32),
        jnp.zeros((R, 1), jnp.float32),
        jnp.zeros((R, 1), jnp.float32),
        jnp.zeros((R, 1), bool),
    )
    _, best_t, _, best_slot, best_u, best_v, occ = jax.lax.while_loop(
        cond, body, init
    )
    return best_t, best_slot, best_u, best_v, occ


def intersect(packed: PackedBVH, scene: Scene, ro, rd, t_min, t_max) -> Hit:
    best_t, best_slot, best_u, best_v, _ = _traverse(
        packed, ro, rd, t_min, t_max, any_hit=False
    )
    found = best_t < jnp.broadcast_to(t_max, best_t.shape)
    return Hit(
        hit=found,
        t=jnp.where(found, best_t, INF),
        prim=packed.prim_gid[best_slot],
        u=best_u,
        v=best_v,
    )


def occluded(packed: PackedBVH, scene: Scene, ro, rd, t_max):
    t_min = jnp.zeros_like(t_max)
    _, _, _, _, occ = _traverse(packed, ro, rd, t_min, t_max, any_hit=True)
    return occ
