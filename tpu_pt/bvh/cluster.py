"""Cluster BVH — the production acceleration structure.

The classic per-ray stackless BVH walk (bvh/packed.py) is a lock-stepped
``while_loop`` of per-lane row gathers: every iteration waits for the
slowest lane.  Instead of the reference's per-thread traversal (SURVEY.md
§3.2 "iterative BVH traversal ... one thread/pixel"), the scene is
re-shaped for dense, static-shape XLA work:

  1. **Clusters**: SAH leaves of <=TILE (128) primitives, pretransformed to
     a (C, 12, 128) tile tensor — prim lane = minor axis, so one cluster is
     a 6 KB contiguous block and Möller–Trumbore over a whole tile is
     dense (.., 128)-lane math.
  2. **Implicit 8-ary level pyramid** over cluster AABBs: level l+1 packs
     the 8 children of node i at rows [8i, 8i+8), so the traversal needs NO
     index tables at all — child fetch is a contiguous block gather.
  3. **Level-synchronous frontier traversal**: every ray carries a fixed-F
     frontier of live nodes per level; each descent step is one block
     gather + a dense (Q, F, 8) slab test + one compaction.  No
     data-dependent while_loop, ~4 dense steps total.
  4. **Pair compaction + dense intersection**: (ray, cluster) candidates are
     compacted by one stable sort, tiles fetched with one big contiguous
     block gather, intersected densely, and reduced per ray.

Capacity contract: frontier widths F and the leaf candidate count K are
static compile-time knobs.  Truncation is *counted* (``candidate_stats``)
and the shipped defaults are verified overflow-free on the test scenes; the
roadmap item for exact resume-on-overflow is tracked in README.  This is the
same engineering posture as GPU short-stack traversal with restart trails.

Reference parity: replaces BVHAccel::intersect / the CUDA intersect_bvh
(SURVEY.md §2 rows 9, 14) as the production intersector.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.core.intersect import INF
from tpu_pt.render.brute import Hit
from tpu_pt.scene.types import Scene

TILE = 128  # primitives per cluster (the tile tensor's minor axis)


def _bf16_outward(lo: np.ndarray, hi: np.ndarray):
    """Round AABBs OUTWARD onto the bf16 grid (lo down, hi up) so that a
    bf16 slab test can only produce false POSITIVES, never a false miss —
    candidate selection stays exact while the gathered level tables halve
    in bytes (the descent's child fetches are small random block gathers).

    Works in bf16 magnitude-bit space: truncating an f32 to its high 16
    bits rounds toward zero, so the needed 1-ulp nudge is sign-dependent.
    """
    def trunc(x):
        b = x.astype(np.float32).view(np.uint32)
        return (b >> 16).astype(np.uint16)

    def val(h):
        return (h.astype(np.uint32) << 16).view(np.float32)

    h_lo = trunc(lo)
    need = val(h_lo) > lo          # only for negative lo (trunc went up)
    h_lo = (h_lo + need.astype(np.uint16))
    h_hi = trunc(hi)
    need = val(h_hi) < hi          # only for positive hi (trunc went down)
    h_hi = (h_hi + need.astype(np.uint16))
    return val(h_lo), val(h_hi)


def _levels16_jnp(levels):
    """jnp version of :func:`_levels16` (the jitted device build path)."""
    def trunc(x):
        b = jax.lax.bitcast_convert_type(x, jnp.uint32)
        return (b >> 16).astype(jnp.uint16)

    def val(h):
        return jax.lax.bitcast_convert_type(
            h.astype(jnp.uint32) << 16, jnp.float32)

    out = []
    for lv in levels:
        lo, hi = lv[:, 0:3], lv[:, 3:6]
        h_lo = trunc(lo)
        h_lo = h_lo + (val(h_lo) > lo).astype(jnp.uint16)
        h_hi = trunc(hi)
        h_hi = h_hi + (val(h_hi) < hi).astype(jnp.uint16)
        row = jnp.zeros((lv.shape[0], 8), jnp.bfloat16)
        row = row.at[:, 0:3].set(val(h_lo).astype(jnp.bfloat16))
        row = row.at[:, 3:6].set(val(h_hi).astype(jnp.bfloat16))
        out.append(row)
    return out


def _levels16(levels):
    """bf16-grid outward-rounded copies of the level tables (still stored
    as f32 rows holding bf16-exact values; the gather path re-encodes them
    as bf16 so gathered bytes halve)."""
    import ml_dtypes

    out = []
    for lv in levels:
        lo, hi = _bf16_outward(np.asarray(lv[:, 0:3]), np.asarray(lv[:, 3:6]))
        row = np.zeros((lv.shape[0], 8), ml_dtypes.bfloat16)
        row[:, 0:3] = lo.astype(ml_dtypes.bfloat16)
        row[:, 3:6] = hi.astype(ml_dtypes.bfloat16)
        out.append(row)
    return out


@jax.tree_util.register_pytree_node_class
class ClusterBVH:
    """levels[l]: (N_l, 8) f32 rows [min.xyz, max.xyz, 0, 0], root-first;
    each level is padded so that level[l+1] has exactly 8*N_l rows (empty
    slots have min=+INF, max=-INF and fail every slab test).
    levels16[l]: bf16 copies rounded OUTWARD (lo down / hi up) — the
      gathered tables of the descent (half the bytes, zero lost hits).
    tiles: (C, 12, 128) f32 — lane p of cluster c holds primitive p as
      rows [v0.xyz, e1.xyz, e2.xyz, type, 0, 0] (tri: edges; sphere:
      v0=center, e1.x=radius, type=1; padding lanes are all-zero => miss).
    tile_gid: (C, 128) i32 global primitive id (pad lanes 0 — never hit).
    frontiers / k_leaf: static per-level frontier capacities and the leaf
    candidate budget (compile keys)."""

    def __init__(self, levels, tiles, tile_gid, frontiers: tuple,
                 k_leaf: int, pair_budget: int,
                 pair_mults: tuple = (8, 8, 6), levels16=None,
                 fallback=None):
        self.levels = tuple(levels)
        self.tiles = tiles
        self.tile_gid = tile_gid
        self.frontiers = tuple(frontiers)
        self.k_leaf = k_leaf
        self.pair_budget = pair_budget
        # Pair-major traversal budgets, × Q: (top flatten, intermediate
        # levels, leaf/cluster pairs[, any-hit leaf pairs]).  Static compile
        # knobs; truncation is counted (pairs_stats / compact_stats).  The
        # leaf mult covers the WORST CONTIGUOUS-PIXEL BLOCK of the 1.3M-tri
        # bench camera (coherent wavefront respawn batches share clusters,
        # so their candidate totals run ~1.4x the random-pixel average;
        # measured worst block = 23,312 candidates at Q=4096 -> mult 6).
        # The 4th entry is the NARROW any-hit pair budget: in steady state
        # shadow batches carry useful rays on only ~half their lanes
        # (n_shadow ≈ 0.49·n_closest on the bench), so ~2/3 of the leaf
        # mult holds them (bench: 4 vs 6).  Batches that exceed
        # it — e.g. the fully-occupied wide-angle step-0 shadow wave of a
        # small render, measured needing mult 5 at 128² — take the WIDE
        # rung (pair_mults[2]) of the runtime budget ladder
        # (the wavefront's unrolled wide prefix) instead of truncating.
        # Legacy 3-tuples get the
        # derived default.
        pair_mults = tuple(pair_mults)
        if len(pair_mults) == 3:
            pair_mults += (max(2, -(-2 * pair_mults[2] // 3)),)
        self.pair_mults = pair_mults
        if levels16 is None:
            levels16 = _levels16(self.levels)  # host (numpy) build path
        self.levels16 = tuple(levels16)
        # Optional exact-retrace fallback (PackedBVH): rays whose candidates
        # overflowed ANY static budget are re-traced through the exact
        # per-ray octant walk, so capacity overflow degrades to slower,
        # never to a dropped hit (VERDICT r3 task 1d).
        self.fallback = fallback

    def tree_flatten(self):
        return (self.levels, self.tiles, self.tile_gid, self.levels16,
                self.fallback), (
            self.frontiers, self.k_leaf, self.pair_budget, self.pair_mults)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, tiles, tile_gid, levels16, fallback = children
        return cls(levels, tiles, tile_gid, frontiers=aux[0], k_leaf=aux[1],
                   pair_budget=aux[2],
                   pair_mults=aux[3] if len(aux) > 3 else (8, 8, 6),
                   levels16=levels16, fallback=fallback)

    @property
    def n_clusters(self) -> int:
        return self.tiles.shape[0]


def _prim_lane_rows(scene: Scene, pid: np.ndarray) -> np.ndarray:
    """(len(pid), 12) packed rows for the tile tensor (before transpose)."""
    v = np.asarray(scene.vertices)
    ti = np.asarray(scene.tri_idx)
    sc = np.asarray(scene.sph_center)
    sr = np.asarray(scene.sph_radius)
    n_tris = ti.shape[0]
    rows = np.zeros((len(pid), 12), np.float32)
    is_tri = pid < n_tris
    tg = pid[is_tri]
    v0 = v[ti[tg, 0]]
    rows[is_tri, 0:3] = v0
    rows[is_tri, 3:6] = v[ti[tg, 1]] - v0
    rows[is_tri, 6:9] = v[ti[tg, 2]] - v0
    sg = pid[~is_tri] - n_tris
    rows[~is_tri, 0:3] = sc[sg]
    rows[~is_tri, 3] = sr[sg]
    rows[~is_tri, 9] = 1.0
    return rows


def default_frontiers(level_sizes: Sequence[int]):
    """Per-level frontier capacities (top-first) + leaf candidate budget K.

    A ray through an n^3-cell grid pierces ~3n cells.  The leaf level
    matches that model well (bench 1.3M-tri scene: measured max need 49 vs
    cap 69), but INTERMEDIATE levels need ~4n: their AABBs overlap more
    (each is the union of 8 children), so a ray stabs more of them than the
    disjoint-grid estimate.  r3's 2.5n+8 mid caps truncated 1,318
    candidates on the real mixed-depth wavefront of the headline bench
    (tools/attribute_overflow.py: level-0 needed 25 vs cap 23, level-1
    needed 47 vs cap 38); 4n+10 covers the measured max with >=1.25x
    margin.  The warmed-wavefront autotuner (autotune_for_render) replaces
    these static estimates with measured per-scene maxima."""
    caps = []
    last = len(level_sizes) - 1
    for i, s in enumerate(level_sizes):
        n = max(1.0, float(s)) ** (1.0 / 3.0)
        if i == last:
            caps.append(int(min(s, max(12, int(2.5 * n) + 8))))
        else:
            caps.append(int(min(s, max(16, int(4.0 * n) + 10))))
    return tuple(caps), caps[-1]


def build_cluster_bvh(scene: Scene, tile: int = TILE,
                      frontiers: Sequence[int] | None = None,
                      k_leaf: int | None = None,
                      pair_budget: int | None = None,
                      dense_start: int = 512,
                      pair_mults: Sequence[int] | None = None) -> ClusterBVH:
    """Host build: SAH leaves (<=tile prims) from the native C++ builder
    -> padded tile tensor + implicit 8-ary AABB pyramid (all numpy; upload
    via device_put)."""
    from tpu_pt.bvh import native

    start, cnt, lo, hi, pid = native.build_leaves(scene, max_leaf=tile)
    C = len(start)

    # Tile tensor: (C, 12, tile) with zero padding (zero rows never hit:
    # zero edges => det 0 for triangles, radius 0 for spheres).  Lanes are
    # sorted by gid within each cluster so "first lane at min t" — the
    # argmin rule of the pair test — IS the lowest-gid tie-break (SURVEY.md
    # §4 item 2).
    rows_all = _prim_lane_rows(scene, pid)  # (P, 12) in leaf order
    rows = np.zeros((C, tile, 12), np.float32)
    gid = np.zeros((C, tile), np.int32)
    for c in range(C):
        s, n = start[c], cnt[c]
        o = np.argsort(pid[s:s + n], kind="stable")
        rows[c, :n] = rows_all[s:s + n][o]
        gid[c, :n] = pid[s:s + n][o]
    tiles = np.ascontiguousarray(rows.transpose(0, 2, 1))  # (C, 12, tile)

    # Implicit 8-ary pyramid: sizes fixed top-down so level l+1 has exactly
    # 8x the rows of level l (the ladder N0, 8*N0, 64*N0, ... >= C); slots
    # beyond real nodes are empty AABBs (min=+INF > max=-INF, never hit).
    # The top level is tested DENSELY against every ray (a (Q, N0) slab test
    # is cheap elementwise math), so it can be hundreds of nodes wide —
    # every level it replaces removes a block-gather + compaction step.
    n_levels = 1
    top = C
    while top > dense_start:
        top = -(-top // 8)
        n_levels += 1
    sizes = [top * 8 ** l for l in range(n_levels)]  # top-first

    bot = np.zeros((sizes[-1], 8), np.float32)
    bot[:, 0:3] = np.inf
    bot[:, 3:6] = -np.inf
    bot[:C, 0:3] = lo
    bot[:C, 3:6] = hi
    levels = [bot]
    for _ in range(n_levels - 1):
        child = levels[0]
        parent = np.zeros((child.shape[0] // 8, 8), np.float32)
        parent[:, 0:3] = child[:, 0:3].reshape(-1, 8, 3).min(1)
        parent[:, 3:6] = child[:, 3:6].reshape(-1, 8, 3).max(1)
        levels.insert(0, parent)

    if frontiers is None or k_leaf is None:
        df, dk = default_frontiers([lv.shape[0] for lv in levels])
        frontiers = tuple(frontiers) if frontiers is not None else df
        k_leaf = int(k_leaf) if k_leaf is not None else dk
    assert len(frontiers) == len(levels), (frontiers, sizes)
    # Small by design: rounds 2+ of the best-t-feedback loop make any
    # budget exact, so this only tunes round-1 hit rate vs wasted tests.
    pair_budget = pair_budget or min(k_leaf, 4)
    if pair_mults is not None:
        return ClusterBVH(levels, tiles, gid, tuple(frontiers), int(k_leaf),
                          int(pair_budget), pair_mults=tuple(pair_mults))
    return ClusterBVH(levels, tiles, gid, tuple(frontiers), int(k_leaf),
                      int(pair_budget))


def _ladder_sizes(C: int, dense_start: int):
    n_levels = 1
    top = C
    while top > dense_start:
        top = -(-top // 8)
        n_levels += 1
    return [top * 8 ** l for l in range(n_levels)]  # top-first


def _sah_split_round(rows, gid_f, live, lo_f, hi_f, C: int, tile: int,
                     split_tau):
    """One SAH-swept window-split round of the device cluster build.

    Treats each of the C current chunks (contiguously lane-filled from 0)
    as a window, sweeps all internal cut positions via prefix/suffix box
    scans (exact 1-D SAH: areaL·nL + areaR·nR), and splits the window into
    chunk slots 2w / 2w+1 iff the best cut beats ``split_tau`` × the
    unsplit cost.  Unsplit windows leave slot 2w+1 empty (inverted AABB —
    never a candidate).  All static shapes: returns arrays of size 2C·tile
    and the new chunk count 2C."""
    lo_w = lo_f.reshape(C, tile, 3)
    hi_w = hi_f.reshape(C, tile, 3)
    pre_lo = jax.lax.cummin(lo_w, axis=1)
    pre_hi = jax.lax.cummax(hi_w, axis=1)
    suf_lo = jax.lax.cummin(lo_w, axis=1, reverse=True)
    suf_hi = jax.lax.cummax(hi_w, axis=1, reverse=True)

    def _area(l, h):
        d = jnp.maximum(h - l, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    live_w = live.reshape(C, tile)
    n_w = jnp.sum(live_w, axis=1, dtype=jnp.int32)          # live per window
    i_cut = jnp.arange(1, tile)
    nL = jnp.minimum(i_cut[None, :], n_w[:, None]).astype(jnp.float32)
    nR = n_w[:, None].astype(jnp.float32) - nL
    # Cut at i: left = lanes [0, i) (prefix index i-1), right = [i, tile).
    cost = (_area(pre_lo[:, :-1], pre_hi[:, :-1]) * nL
            + _area(suf_lo[:, 1:], suf_hi[:, 1:]) * nR)
    whole = _area(pre_lo[:, -1], pre_hi[:, -1]) * n_w.astype(jnp.float32)
    best = jnp.argmin(cost, axis=1).astype(jnp.int32)
    do_split = jnp.min(cost, axis=1) < split_tau * whole
    cut = jnp.where(do_split, best + 1, tile)               # (C,)

    o = jnp.broadcast_to(jnp.arange(tile)[None, :], (C, tile))
    right = o >= cut[:, None]
    w_ix = jnp.broadcast_to(jnp.arange(C)[:, None], (C, tile))
    chunk = 2 * w_ix + right.astype(jnp.int32)
    lane = o - jnp.where(right, cut[:, None], 0)
    slot = (chunk * tile + lane).reshape(-1)                # unique slots
    C2 = 2 * C
    rows = jnp.zeros((C2 * tile, 12)).at[slot].set(rows)
    gid_f = jnp.zeros((C2 * tile,), jnp.int32).at[slot].set(gid_f)
    live = jnp.zeros((C2 * tile,), bool).at[slot].set(live)
    lo_f = jnp.full((C2 * tile, 3), jnp.inf).at[slot].set(lo_f)
    hi_f = jnp.full((C2 * tile, 3), -jnp.inf).at[slot].set(hi_f)
    return rows, gid_f, live, lo_f, hi_f, C2


def build_cluster_device(scene: Scene, tile: int = TILE,
                         frontiers: Sequence[int] | None = None,
                         k_leaf: int | None = None,
                         pair_budget: int | None = None,
                         dense_start: int = 512,
                         cap_scale: float = 1.35,
                         split_tau: float | None = 0.5,
                         split_rounds: int = 1) -> ClusterBVH:
    """DEVICE cluster build — the LBVH-style fast path (BASELINE.json
    config 3: "LBVH device build, Morton sort on device").

    Primitives are Morton-sorted by centroid and chopped into consecutive
    ``tile``-sized chunks; chunk AABBs form the pyramid.  Everything is XLA
    ops on static shapes (jit-able, reruns per animation frame).  Cluster
    quality is below the host SAH build (Morton chunks overlap more), which
    costs traversal time, not correctness — same capacity contract.

    split_tau (r5, VERDICT r4 task 4's quality lever): SAH-swept window
    refinement.  Each ``tile``-wide Morton window is swept for its best
    internal cut with prefix/suffix box scans (exact 1-D SAH over all 127
    cut positions, pure cummin/cummax on the lane axis); the window splits
    into two chunks iff the best cut's SAH cost — areaL·nL + areaR·nR —
    drops below ``split_tau`` × the unsplit cost.  Chunk slots are STATIC
    (2 per window; unsplit windows leave slot 2w+1 empty with an inverted
    AABB that never attracts candidates), so the build stays jit-able with
    shapes known at trace time.  This targets exactly the Morton-chunk
    failure mode: windows straddling a Z-order jump union two distant
    blobs into one huge box.  ``None`` disables (plain chunking).
    """
    from tpu_pt.bvh.lbvh import morton_codes

    v = scene.vertices
    ti = scene.tri_idx
    n_tris = scene.n_tris
    p0, p1, p2 = v[ti[:, 0]], v[ti[:, 1]], v[ti[:, 2]]
    tri_lo = jnp.minimum(jnp.minimum(p0, p1), p2)
    tri_hi = jnp.maximum(jnp.maximum(p0, p1), p2)
    sph_lo = scene.sph_center - scene.sph_radius[:, None]
    sph_hi = scene.sph_center + scene.sph_radius[:, None]
    lo = jnp.concatenate([tri_lo, sph_lo], axis=0)
    hi = jnp.concatenate([tri_hi, sph_hi], axis=0)
    P = lo.shape[0]

    cent = (lo + hi) * 0.5
    codes = morton_codes(cent, jnp.min(lo, axis=0), jnp.max(hi, axis=0))
    order = jnp.argsort(codes).astype(jnp.int32)

    # Packed (P, 12) primitive rows in Morton order (one-time gathers).
    og = order
    is_tri = og < n_tris
    tg = jnp.where(is_tri, og, 0)
    a0 = v[ti[tg, 0]]
    e1 = v[ti[tg, 1]] - a0
    e2 = v[ti[tg, 2]] - a0
    rows = jnp.zeros((P, 12), jnp.float32)
    if scene.n_spheres == 0:
        rows = rows.at[:, 0:3].set(a0)
        rows = rows.at[:, 3:6].set(e1)
        rows = rows.at[:, 6:9].set(e2)
    else:
        sg = jnp.where(is_tri, 0, og - n_tris)
        c0 = scene.sph_center[sg]
        r0 = scene.sph_radius[sg]
        rows = rows.at[:, 0:3].set(jnp.where(is_tri[:, None], a0, c0))
        rows = rows.at[:, 3:6].set(jnp.where(
            is_tri[:, None], e1,
            jnp.concatenate([r0[:, None], jnp.zeros((P, 2))], -1)))
        rows = rows.at[:, 6:9].set(jnp.where(is_tri[:, None], e2, 0.0))
        rows = rows.at[:, 9].set(jnp.where(is_tri, 0.0, 1.0))

    C = -(-P // tile)
    pad = C * tile - P
    rows = jnp.concatenate([rows, jnp.zeros((pad, 12))], axis=0)
    gid_f = jnp.concatenate([og, jnp.zeros((pad,), jnp.int32)])
    live = jnp.arange(C * tile) < P
    lo_f = jnp.concatenate([lo[og], jnp.full((pad, 3), jnp.inf)], axis=0)
    hi_f = jnp.concatenate([hi[og], jnp.full((pad, 3), -jnp.inf)], axis=0)

    if split_tau is not None:
        for _ in range(max(1, int(split_rounds))):
            rows, gid_f, live, lo_f, hi_f, C = _sah_split_round(
                rows, gid_f, live, lo_f, hi_f, C, tile, split_tau)

    gid = gid_f.reshape(C, tile)
    live_w = live.reshape(C, tile)
    # Sort lanes by gid within each cluster, padding lanes last (lowest-gid
    # tie rule; padding rows are all-zero and never hit, gid 0 by contract).
    key = jnp.where(live_w, gid, jnp.int32(2**31 - 1))
    lane_o = jnp.argsort(key, axis=1).astype(jnp.int32)
    gid = jnp.where(jnp.take_along_axis(live_w, lane_o, axis=1),
                    jnp.take_along_axis(gid, lane_o, axis=1), 0)
    rows = jnp.take_along_axis(
        rows.reshape(C, tile, 12), lane_o[:, :, None], axis=1)
    tiles = rows.transpose(0, 2, 1)

    c_lo = jnp.min(lo_f.reshape(C, tile, 3), axis=1)
    c_hi = jnp.max(hi_f.reshape(C, tile, 3), axis=1)

    sizes = _ladder_sizes(C, dense_start)
    pad_c = sizes[-1] - C
    cur_lo = jnp.concatenate([c_lo, jnp.full((pad_c, 3), jnp.inf)], axis=0)
    cur_hi = jnp.concatenate([c_hi, jnp.full((pad_c, 3), -jnp.inf)], axis=0)
    levels = []
    for li in range(len(sizes)):
        row = jnp.concatenate(
            [cur_lo, cur_hi, jnp.zeros((cur_lo.shape[0], 2))], axis=1)
        levels.insert(0, row.astype(jnp.float32))
        if li < len(sizes) - 1:
            cur_lo = jnp.min(cur_lo.reshape(-1, 8, 3), axis=1)
            cur_hi = jnp.max(cur_hi.reshape(-1, 8, 3), axis=1)

    if frontiers is None or k_leaf is None:
        # Morton-chunk clusters overlap far more than SAH clusters: with
        # SAH-sized default caps the 1.3M-tri headline render truncated
        # 733,453 candidates (r5 measurement).  cap_scale widens the
        # geometric defaults to cover the quality gap; the extra width is
        # the honest traversal-time cost of the fast device build.
        # With SAH window refinement the tables are 2x-padded (half the
        # slots empty), so the n^(1/3) cap model runs on the PRE-SPLIT
        # ladder scale — per-ray candidate needs only drop vs the plain
        # chunking (measured: mid-level max 13/26 vs 18/38 unrefined,
        # leaf mean -21% at tau 0.5 on the 327k proxy).
        sz = [lv.shape[0] for lv in levels]
        eff = sz if split_tau is None else \
            [max(1, s >> int(split_rounds)) for s in sz]
        df, dk = default_frontiers(eff)
        df = tuple(min(s, int(np.ceil(c * cap_scale)))
                   for s, c in zip(sz, df))
        dk = min(sz[-1], int(np.ceil(dk * cap_scale)))
        frontiers = tuple(frontiers) if frontiers is not None else df
        k_leaf = int(k_leaf) if k_leaf is not None else dk
    pair_budget = pair_budget or min(k_leaf, 4)
    mults = (8, 8, int(np.ceil(6 * cap_scale)), int(np.ceil(4 * cap_scale)))
    return ClusterBVH(levels, tiles.astype(jnp.float32), gid,
                      tuple(frontiers), int(k_leaf), int(pair_budget),
                      pair_mults=mults, levels16=_levels16_jnp(levels))


# ---------------------------------------------------------------------------
# Traversal (device)
# ---------------------------------------------------------------------------


def _slab(b_lo, b_hi, ro, rd_inv, t_min, t_max):
    """Entry t of ray vs AABB, INF on miss.  Shapes broadcast; returns
    max(t_near, t_min) where the slab interval intersects [t_min, t_max].

    Empty boxes (padding slots, min=+INF > max=-INF) must MISS: their slabs
    degenerate to near=-inf/far=+inf which would hit everything, so validity
    is tested explicitly."""
    lo = (b_lo - ro) * rd_inv
    hi = (b_hi - ro) * rd_inv
    near = jnp.minimum(lo, hi)
    far = jnp.maximum(lo, hi)
    near = jnp.where(jnp.isnan(near), -jnp.inf, near)
    far = jnp.where(jnp.isnan(far), jnp.inf, far)
    t0 = jnp.maximum(jnp.max(near, axis=-1), t_min)
    t1 = jnp.minimum(jnp.min(far, axis=-1), t_max)
    box_valid = b_lo[..., 0] <= b_hi[..., 0]
    return jnp.where(box_valid & (t0 <= t1), t0, INF)


def _descend(cb: ClusterBVH, ro, rd_inv, t_min, t_max):
    """Frontier descent.  Returns (cand_idx (Q, K) i32 t-ascending cluster
    ids (slot invalid => t INF), cand_t (Q, K), overflow (Q,) i32 count of
    finite candidates truncated at any level)."""
    Q = ro.shape[0]
    levels = cb.levels
    caps = cb.frontiers
    K = cb.k_leaf
    ro_b = ro[:, None, :]
    ri_b = rd_inv[:, None, :]

    # Top level: dense test of all rows.
    top = levels[0]
    te = _slab(top[None, :, 0:3], top[None, :, 3:6], ro_b, ri_b,
               t_min, t_max)  # (Q, N0)
    idx = jnp.broadcast_to(
        jnp.arange(top.shape[0], dtype=jnp.int32)[None, :], te.shape)
    overflow = jnp.zeros((Q,), jnp.int32)

    def sort_trunc(te, idx, cap):
        # Sort keys in bf16, ROUNDED DOWN (bit truncation — exact for
        # non-negative floats), so the returned entry-t is a conservative
        # lower bound and best-t pruning stays exact.  INF is a finite
        # sentinel (1e30) whose truncation is 9.953e29 — snap it back, or
        # every miss would read as a hit.
        te16 = jax.lax.convert_element_type(
            jax.lax.bitcast_convert_type(
                jax.lax.bitcast_convert_type(te, jnp.int32)
                & jnp.int32(-65536), jnp.float32),
            jnp.bfloat16)
        te16, idx = jax.lax.sort((te16, idx), dimension=1, num_keys=1)
        te = jax.lax.convert_element_type(te16, jnp.float32)
        te = jnp.where(te >= 9.953038e29, INF, te)
        ovf = jnp.sum((te[:, cap:] < INF), axis=1, dtype=jnp.int32) \
            if te.shape[1] > cap else jnp.int32(0)
        return te[:, :cap], idx[:, :cap], ovf

    F = min(caps[0], top.shape[0])
    if te.shape[1] > F:
        te, idx, ovf = sort_trunc(te, idx, F)
        overflow += ovf

    for l in range(1, len(levels)):
        # Gather children as FLAT (64,) rows from the bf16 outward-rounded
        # tables (half the bytes, conservative: no lost hits).
        src = cb.levels16[l] if GATHER_BF16 else levels[l]
        child = src.reshape(-1, 64)
        blk = child[jnp.maximum(idx, 0)].astype(jnp.float32).reshape(
            idx.shape + (8, 8))
        tc = _slab(blk[..., 0:3], blk[..., 3:6], ro_b[:, :, None, :],
                   ri_b[:, :, None, :], t_min[..., None], t_max[..., None])
        tc = jnp.where(te[..., None] < INF, tc, INF)  # dead parents
        cidx = idx[..., None] * 8 + jnp.arange(8, dtype=jnp.int32)
        cap = K if l == len(levels) - 1 else min(caps[l], levels[l].shape[0])
        te, idx, ovf = sort_trunc(tc.reshape(Q, -1), cidx.reshape(Q, -1), cap)
        overflow += ovf
    return idx, te, overflow


def _prim_tile_test(tile, ro, rd, t_min, t_max):
    """Dense MT + sphere test of rays vs their tile.  tile: (P, 12, L);
    ro/rd: (P, 3); t bounds (P, 1).  Returns (t (P, L), u, v) with INF on
    miss — all dense lane-axis math, no gathers."""
    v0 = tile[:, 0:3, :]
    e1 = tile[:, 3:6, :]
    e2 = tile[:, 6:9, :]
    typ = tile[:, 9, :]
    ro_b = ro[:, :, None]
    rd_b = rd[:, :, None]

    def cross(a, b):
        return jnp.stack([
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ], axis=1)

    pvec = cross(jnp.broadcast_to(rd_b, e2.shape), e2)
    det = jnp.sum(e1 * pvec, axis=1)
    parallel = jnp.abs(det) < 1e-12
    inv_det = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, det))
    tvec = ro_b - v0
    u = jnp.sum(tvec * pvec, axis=1) * inv_det
    qvec = cross(tvec, e1)
    vv = jnp.sum(rd_b * qvec, axis=1) * inv_det
    t_tri = jnp.sum(e2 * qvec, axis=1) * inv_det
    ok_tri = (~parallel) & (u >= 0) & (vv >= 0) & (u + vv <= 1) \
        & (t_tri >= t_min) & (t_tri <= t_max)

    # Sphere lanes (type==1): v0 = center, e1.x = radius.
    oc = ro_b - v0
    radius = e1[:, 0, :]
    a = jnp.sum(rd_b * rd_b, axis=1)
    b = 2.0 * jnp.sum(oc * rd_b, axis=1)
    c = jnp.sum(oc * oc, axis=1) - radius * radius
    disc = b * b - 4 * a * c
    has = disc >= 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 1.0 / jnp.maximum(2 * a, 1e-20)
    s0 = (-b - sq) * inv2a
    s1 = (-b + sq) * inv2a
    ok0 = has & (s0 >= t_min) & (s0 <= t_max)
    ok1 = has & (s1 >= t_min) & (s1 <= t_max)
    t_sph = jnp.where(ok0, s0, s1)
    ok_sph = ok0 | ok1

    is_sph = typ > 0.5
    ok = jnp.where(is_sph, ok_sph, ok_tri)
    t = jnp.where(is_sph, t_sph, t_tri)
    t = jnp.where(ok, t, INF)
    return t, jnp.where(is_sph, 0.0, u), jnp.where(is_sph, 0.0, vv)


def _seg_min(t, seg_start, gid=None):
    """Segmented running min along axis 0: resets where seg_start.  Returns
    (min_t, argmin position) per element (inclusive).  With ``gid``, ties
    in t are broken by LOWEST gid (the cross-backend tie rule of
    SURVEY.md §4 item 2)."""
    n = t.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    if gid is None:
        def combine(a, b):
            ta, ia, fa = a
            tb, ib, fb = b
            take_b = fb | (tb < ta)
            return (jnp.where(take_b, tb, jnp.minimum(ta, tb)),
                    jnp.where(take_b, ib, ia),
                    fa | fb)

        mt, mi, _ = jax.lax.associative_scan(combine, (t, pos, seg_start))
        return mt, mi

    def combine(a, b):
        ta, ga, ia, fa = a
        tb, gb, ib, fb = b
        take_b = fb | (tb < ta) | ((tb == ta) & (gb < ga))
        return (jnp.where(take_b, tb, ta),
                jnp.where(take_b, gb, ga),
                jnp.where(take_b, ib, ia),
                fa | fb)

    mt, _, mi, _ = jax.lax.associative_scan(combine, (t, gid, pos, seg_start))
    return mt, mi


def _test_pair_batch(cb: ClusterBVH, ro, rd, t_min1, t_max1, ray_c, cid_c,
                     pair_ok):
    """Dense tile intersection of a flat pair batch.  Returns per-pair
    (t (P,), u, v, gid) with INF on miss."""
    cid_c = jnp.clip(cid_c, 0, cb.n_clusters - 1)
    tile = cb.tiles[cid_c]                          # (P, 12, L) block gather
    t_lane, u_lane, v_lane = _prim_tile_test(
        tile, ro[ray_c], rd[ray_c], t_min1[ray_c][:, None],
        t_max1[ray_c][:, None])
    t_lane = jnp.where(pair_ok[:, None], t_lane, INF)
    t_pair = jnp.min(t_lane, axis=1)
    # argmin keeps the FIRST lane at the min t — and tile lanes are sorted
    # by gid at build time, so this IS the lowest-gid tie rule (SURVEY.md
    # §4 item 2) with no extra gather or pass.
    lane = jnp.argmin(t_lane, axis=1)
    ar = jnp.arange(t_lane.shape[0])
    return (t_pair, u_lane[ar, lane], v_lane[ar, lane],
            cb.tile_gid[cid_c, lane])


def _traverse(cb: ClusterBVH, scene: Scene, ro, rd, t_min, t_max):
    """Closest-hit over candidate clusters — EXACT for any pair budget.

    Candidates per ray are t_entry-ascending, so untested candidates always
    lie BEHIND the current best hit.  Round 1 tests the first
    ``pair_budget`` slots per ray (plain slice, no compaction); a while_loop
    then repeatedly compacts and tests only the pairs whose cluster entry-t
    still beats that ray's best hit (a contiguous slot range [cursor, end)
    per ray, since cand_t is sorted).  Each iteration consumes >=1 pair, so
    the loop terminates; in practice round 1 already resolves almost every
    ray and the loop runs 0-2 times.  Returns (best_t (Q,1), gid (Q,),
    u (Q,1), v (Q,1)).
    """
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rd_inv = 1.0 / rd
    cand, cand_t, ovf = _descend(cb, ro, rd_inv, t_min1[:, None],
                                 t_max1[:, None])
    n_ovf = jnp.sum(ovf)
    K = cand.shape[1]
    ray_of = jnp.broadcast_to(
        jnp.arange(Q, dtype=jnp.int32)[:, None], (Q, K))

    # ---- Round 1: nearest pair_budget candidates per ray, reduced with a
    # plain (Q, pb) min — no compaction, no segmented scan.
    pb = min(cb.pair_budget, K)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1,
        ray_of[:, :pb].reshape(-1), cand[:, :pb].reshape(-1),
        (cand_t[:, :pb] < INF).reshape(-1))
    t_p = t_p.reshape(Q, pb)
    g_2d = g_p.reshape(Q, pb)
    best_t = jnp.min(t_p, axis=1)
    at_min = t_p == best_t[:, None]
    g_min = jnp.min(jnp.where(at_min, g_2d, jnp.int32(2**31 - 1)), axis=1)
    slot = jnp.argmax(at_min & (g_2d == g_min[:, None]), axis=1)
    arq = jnp.arange(Q)
    best_u = u_p.reshape(Q, pb)[arq, slot]
    best_v = v_p.reshape(Q, pb)[arq, slot]
    best_g = jnp.where(best_t < INF, g_min, 0)

    # ---- Rounds 2+: remaining slots [cursor, end) per ray where
    # end = #candidates with t_entry < best_t (monotonically shrinking).
    P2 = max(Q // 2, 1024)
    slots = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (Q, K))

    def _end(bt):
        # <= so equal-entry-t candidates are still tested: a cluster whose
        # entry t ties the current best may hold an equal-t, LOWER-GID prim
        # (the tie rule of SURVEY.md §4 item 2).
        return jnp.sum((cand_t <= bt[:, None]) & (cand_t < INF), axis=1,
                       dtype=jnp.int32)

    def remaining(cur, bt):
        return jnp.maximum(_end(bt) - cur, 0)

    def cond(state):
        cur, bt, *_ = state
        return jnp.sum(remaining(cur, bt)) > 0

    def body(state):
        cur, bt, bu, bv, bg = state
        end = _end(bt)
        live = (slots >= cur[:, None]) & (slots < end[:, None])
        ray_key = jnp.where(live, ray_of, Q).reshape(-1)
        ray_c, cid_c = jax.lax.sort(
            (ray_key, cand.reshape(-1)), dimension=0, num_keys=1,
            is_stable=True)
        ray_c = ray_c[:P2]
        cid_c = cid_c[:P2]
        ok = ray_c < Q
        ray_cc = jnp.minimum(ray_c, Q - 1)
        t_p, u_p, v_p, g_p = _test_pair_batch(
            cb, ro, rd, t_min1, t_max1, ray_cc, cid_c, ok)
        # Per-ray min over this batch (segments contiguous in ray_c).
        seg_start = jnp.concatenate(
            [jnp.ones((1,), bool), ray_cc[1:] != ray_cc[:-1]])
        mt, mi = _seg_min(t_p, seg_start, gid=g_p)
        left = jnp.searchsorted(ray_c, arq.astype(jnp.int32), side="left")
        right = jnp.searchsorted(ray_c, arq.astype(jnp.int32), side="right")
        has = right > left
        endpos = jnp.clip(right - 1, 0, P2 - 1)
        bt_new = jnp.where(has, mt[endpos], INF)
        bi = mi[endpos]
        g_new = g_p[bi]
        better = has & ((bt_new < bt)
                        | ((bt_new == bt) & (bt < INF) & (g_new < bg)))
        bt = jnp.where(better, bt_new, bt)
        bu = jnp.where(better, u_p[bi], bu)
        bv = jnp.where(better, v_p[bi], bv)
        bg = jnp.where(better, g_new, bg)
        # Advance cursors past every pair consumed this round.
        cur = cur + (right - left).astype(jnp.int32)
        return cur, bt, bu, bv, bg

    state = (jnp.full((Q,), pb, jnp.int32), best_t, best_u, best_v, best_g)
    _, best_t, best_u, best_v, best_g = jax.lax.while_loop(cond, body, state)
    return best_t[:, None], best_g, best_u[:, None], best_v[:, None], n_ovf


# ---------------------------------------------------------------------------
# Pair-major traversal ("pairs" mode)
#
# After a dense top-level slab test, traversal state becomes ONE flat,
# ray-sorted list of live (ray, node) pairs.  Compaction between levels is
# a 1-D key sort, children are gathered only for LIVE pairs, and at the
# leaf every live (ray, cluster) candidate is tile-tested outright — exact
# by construction (no best-t feedback rounds needed).
# ---------------------------------------------------------------------------


def _flatten_live(key_ray, payload, keep: int, Q: int):
    """Compact live pairs to the front, truncate to ``keep``.

    key_ray: (M,) i32 — ray id for live pairs, Q (sentinel) for dead.
    Returns (rayP (keep,), payloadP (keep,), n_dropped scalar)."""
    k, p = jax.lax.sort((key_ray, payload), dimension=0, num_keys=1,
                        is_stable=True)
    n_live = jnp.sum((key_ray < Q).astype(jnp.int32))
    dropped = jnp.maximum(n_live - keep, 0)
    return k[:keep], p[:keep], dropped


def _descend_pairs(cb: ClusterBVH, ro, rd_inv, t_min1, t_max1):
    """Dense top test + pair-major level walk.  Returns (rayP, cidP,
    dropped): ray-sorted live (ray, cluster) candidate pairs (sentinel
    ray=Q padding at the tail) and the count of live pairs truncated by the
    static budget (capacity contract: 0 on supported scenes)."""
    Q = ro.shape[0]
    m_top, m_mid, m_leaf = cb.pair_mults[:3]
    levels = cb.levels
    top = levels[0]

    te = _slab(top[None, :, 0:3], top[None, :, 3:6], ro[:, None, :],
               rd_inv[:, None, :], t_min1[:, None], t_max1[:, None])
    live = te < INF                                        # (Q, N0)
    arq = jnp.arange(Q, dtype=jnp.int32)
    key = jnp.where(live, arq[:, None], Q)
    node = jnp.broadcast_to(
        jnp.arange(top.shape[0], dtype=jnp.int32)[None, :], te.shape)
    keep0 = min(m_top * Q, Q * top.shape[0])
    rayP, nodeP, dropped = _flatten_live(key.reshape(-1), node.reshape(-1),
                                         keep0, Q)

    for l in range(1, len(levels)):
        keep = (m_leaf if l == len(levels) - 1 else m_mid) * Q
        src = cb.levels16[l] if GATHER_BF16 else levels[l]
        child = src.reshape(-1, 64)  # flat (64,) rows per sibling block
        rayPc = jnp.minimum(rayP, Q - 1)
        blk = child[jnp.clip(nodeP, 0, child.shape[0] - 1)].astype(
            jnp.float32).reshape(-1, 8, 8)                 # (P, 8, 8)
        tc = _slab(blk[..., 0:3], blk[..., 3:6],
                   ro[rayPc][:, None, :], rd_inv[rayPc][:, None, :],
                   t_min1[rayPc][:, None], t_max1[rayPc][:, None])  # (P, 8)
        live_c = (tc < INF) & (rayP < Q)[:, None]
        cidx = nodeP[:, None] * 8 + jnp.arange(8, dtype=jnp.int32)[None, :]
        key = jnp.where(live_c, rayPc[:, None], Q)
        rayP, nodeP, drop = _flatten_live(key.reshape(-1),
                                          cidx.reshape(-1), keep, Q)
        dropped = dropped + drop
    return rayP, nodeP, dropped


def _traverse_pairs(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Closest hit via the pair-major walk — exact: every live candidate
    cluster is tile-tested; the per-ray nearest is a segmented min over the
    ray-sorted pair list.  Returns (best_t (Q,1), gid (Q,), u, v)."""
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rayP, cidP, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    P = rayP.shape[0]
    pair_ok = rayP < Q
    rayPc = jnp.minimum(rayP, Q - 1)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, rayPc, cidP, pair_ok)

    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), rayPc[1:] != rayPc[:-1]])
    mt, mi = _seg_min(t_p, seg_start, gid=g_p)
    arq = jnp.arange(Q, dtype=jnp.int32)
    left = jnp.searchsorted(rayP, arq, side="left")
    right = jnp.searchsorted(rayP, arq, side="right")
    has = right > left
    endpos = jnp.clip(right - 1, 0, P - 1)
    best_t = jnp.where(has, mt[endpos], INF)
    bi = mi[endpos]
    best_u = jnp.where(has, u_p[bi], 0.0)
    best_v = jnp.where(has, v_p[bi], 0.0)
    best_g = jnp.where(has, g_p[bi], 0)
    return best_t[:, None], best_g, best_u[:, None], best_v[:, None], dropped


def _traverse_pairs_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Occlusion via the pair-major walk: any live pair with a hit in
    range occludes its ray.  Returns ((Q,) bool, overflow scalar)."""
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rayP, cidP, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    pair_ok = rayP < Q
    rayPc = jnp.minimum(rayP, Q - 1)
    t_p, _, _, _ = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, rayPc, cidP, pair_ok)
    hit_pair = ((t_p < INF) & pair_ok).astype(jnp.int32)
    occ = jnp.zeros((Q,), jnp.int32).at[rayPc].add(hit_pair,
                                                   mode="drop") > 0
    return occ, dropped


def pairs_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Observability for the pair-major path: (n_live_pairs, n_dropped).
    dropped > 0 means pair_mult × Q is too small for this scene/ray set
    (the capacity contract of SURVEY.md §5 metrics, r2 form)."""
    cb = jax.tree.map(jnp.asarray, cb)
    t_min1 = t_min[:, 0] if t_min.ndim == 2 else t_min
    t_max1 = t_max[:, 0] if t_max.ndim == 2 else t_max
    rayP, _, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    return jnp.sum((rayP < ro.shape[0]).astype(jnp.int32)), dropped


def _traverse_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Occlusion test — ANY hit in (t_min, t_max) resolves a ray.

    Same descent as closest-hit, but no best-t feedback: round 1 tests the
    first ``pair_budget`` candidates; the compaction loop then only feeds
    pairs of rays that are still unresolved (no hit yet, finite candidates
    left).  Occluded rays — the common case for NEE shadow rays in interior
    scenes — drop out after round 1, so shadows no longer pay the
    closest-hit feedback rounds (VERDICT r1 weak #2).  Returns (Q,) bool.
    """
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rd_inv = 1.0 / rd
    cand, cand_t, ovf = _descend(cb, ro, rd_inv, t_min1[:, None],
                                 t_max1[:, None])
    n_ovf = jnp.sum(ovf)
    K = cand.shape[1]
    ray_of = jnp.broadcast_to(
        jnp.arange(Q, dtype=jnp.int32)[:, None], (Q, K))

    pb = min(cb.pair_budget, K)
    t_p, _, _, _ = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1,
        ray_of[:, :pb].reshape(-1), cand[:, :pb].reshape(-1),
        (cand_t[:, :pb] < INF).reshape(-1))
    occ = jnp.any(t_p.reshape(Q, pb) < INF, axis=1)

    P2 = max(Q // 2, 1024)
    slots = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (Q, K))
    n_fin = jnp.sum(cand_t < INF, axis=1, dtype=jnp.int32)
    arq = jnp.arange(Q, dtype=jnp.int32)

    def remaining(cur, occ):
        return jnp.where(occ, 0, jnp.maximum(n_fin - cur, 0))

    def cond(state):
        cur, occ = state
        return jnp.sum(remaining(cur, occ)) > 0

    def body(state):
        cur, occ = state
        live = (slots >= cur[:, None]) & (slots < n_fin[:, None]) \
            & ~occ[:, None]
        ray_key = jnp.where(live, ray_of, Q).reshape(-1)
        ray_c, cid_c = jax.lax.sort(
            (ray_key, cand.reshape(-1)), dimension=0, num_keys=1,
            is_stable=True)
        ray_c = ray_c[:P2]
        cid_c = cid_c[:P2]
        ok = ray_c < Q
        ray_cc = jnp.minimum(ray_c, Q - 1)
        t_p, _, _, _ = _test_pair_batch(
            cb, ro, rd, t_min1, t_max1, ray_cc, cid_c, ok)
        hit_pair = ((t_p < INF) & ok).astype(jnp.int32)
        occ = occ | (jnp.zeros((Q,), jnp.int32).at[ray_cc].add(
            hit_pair, mode="drop") > 0)
        left = jnp.searchsorted(ray_c, arq, side="left")
        right = jnp.searchsorted(ray_c, arq, side="right")
        cur = cur + (right - left).astype(jnp.int32)
        return cur, occ

    state = (jnp.full((Q,), pb, jnp.int32), occ)
    _, occ = jax.lax.while_loop(cond, body, state)
    return occ, n_ovf


# ---------------------------------------------------------------------------
# Sort-free compaction traversal ("compact" mode, production).
#
# The frontier walk sorts every level's candidates per ray, and its best-t
# feedback loop is data-dependent.  Sorting is only needed for (a) keeping
# the NEAREST candidates under truncation and (b) making best-t pruning
# exact; if the leaf stage simply tests EVERY live candidate (~2 per ray on
# the bench scene — one flat batch), neither needs ORDER, only COMPACTION.
# 1-bit compaction is sort-free: an inclusive prefix sum ranks the live
# lanes and a fused one-hot reduction places them — dense (Q, N, cap)
# math, no gathers, no comparator passes.
# ---------------------------------------------------------------------------


def _compact_lanes(live, idx, cap: int):
    """Stable 1-bit lane compaction: move live lanes to the front.

    live: (Q, N) bool; idx: (Q, N) i32 payload; cap: static output width.
    Returns (idx_c (Q, cap) i32, live_c (Q, cap) bool, overflow (Q,) i32 —
    live lanes beyond cap, dropped).  out[q, j] = idx of the (j+1)-th live
    lane, via out[q, j] = sum_i idx[q, i] * [rank[q, i] == j+1]; the
    (Q, N, cap) one-hot product fuses into the reduction (never
    materialized), costing ~N*cap mult-adds per ray."""
    n = live.shape[1]
    cap = min(cap, n)
    # Inclusive rank of the live lanes, an exact int32 prefix sum.  (A bf16
    # matmul against a triangular-ones matrix gives the same ranks; on the
    # GPU, XLA's Triton matmul emitter aborted compiling it inside the
    # traversal, and with that emitter off it ran the bench cell slower.)
    rank = jnp.cumsum(live.astype(jnp.int32), axis=1)
    total = rank[:, -1]
    onehot = (live & (rank <= cap))[:, :, None] & (
        rank[:, :, None] == jnp.arange(1, cap + 1, dtype=jnp.int32)[None, None, :])
    idx_c = jnp.sum(jnp.where(onehot, idx[:, :, None], 0), axis=1)
    live_c = jnp.arange(cap, dtype=jnp.int32)[None, :] < total[:, None]
    return idx_c, live_c, jnp.maximum(total - cap, 0)


def _slab_soa(blo, bhi, ro, rd_inv, t_min, t_max):
    """Component-wise (SoA) slab test: blo/bhi are 3-tuples of per-axis
    arrays broadcastable against per-axis ray columns ro[i]/rd_inv[i].

    Same math and float semantics as :func:`_slab` (max/min are exact, so
    reassociating the axis reduction is bit-identical) — but every
    intermediate is a (Q, N) array with the CANDIDATE axis minor, instead
    of the AoS form's (Q, N, 3) with a length-3 minor axis."""
    t0 = t_min
    t1 = t_max
    for i in range(3):
        lo = (blo[i] - ro[i]) * rd_inv[i]
        hi = (bhi[i] - ro[i]) * rd_inv[i]
        near = jnp.minimum(lo, hi)
        far = jnp.maximum(lo, hi)
        near = jnp.where(jnp.isnan(near), -jnp.inf, near)
        far = jnp.where(jnp.isnan(far), jnp.inf, far)
        t0 = jnp.maximum(t0, near)
        t1 = jnp.minimum(t1, far)
    return jnp.where((blo[0] <= bhi[0]) & (t0 <= t1), t0, INF)


def _descend_compact(cb: ClusterBVH, ro, rd_inv, t_min, t_max,
                     collect: list | None = None):
    """Sort-free frontier descent.  Returns (cand (Q, K) i32 cluster ids,
    live (Q, K) bool, overflow (Q,) i32 live candidates truncated at any
    level).  Candidates are lane-compacted but UNORDERED by t — the compact
    traversal tests all of them, so order is irrelevant.

    collect: observability hook — when a list is passed, one
    (needed (Q,), truncated (Q,)) pair per level is appended (needed = live
    candidates BEFORE the cap; attribution for the capacity contract,
    VERDICT r3 task 1a)."""
    Q = ro.shape[0]
    levels = cb.levels
    caps = cb.frontiers
    ro_c = tuple(ro[:, i:i + 1] for i in range(3))          # (Q, 1) each
    ri_c = tuple(rd_inv[:, i:i + 1] for i in range(3))

    topT = levels[0].T                                      # (8, N0)
    te = _slab_soa(tuple(topT[i][None, :] for i in range(3)),
                   tuple(topT[3 + i][None, :] for i in range(3)),
                   ro_c, ri_c, t_min, t_max)                # (Q, N0)
    idx0 = jnp.broadcast_to(
        jnp.arange(levels[0].shape[0], dtype=jnp.int32)[None, :], te.shape)
    cand, live, overflow = _compact_lanes(te < INF, idx0, caps[0])
    if collect is not None:
        collect.append((jnp.sum(te < INF, axis=1, dtype=jnp.int32),
                        overflow))

    for l in range(1, len(levels)):
        src = cb.levels16[l] if GATHER_BF16 else levels[l]
        # Field-major sibling rows: row r = [f0 of children 0..7, f1 of
        # children 0..7, ...] so a field slice of the gathered block keeps
        # the 8 children minor.  The relayout is loop-invariant (hoisted by
        # XLA).
        child = src.reshape(-1, 8, 8).transpose(0, 2, 1).reshape(-1, 64)
        blk = child[jnp.clip(cand, 0, child.shape[0] - 1)]  # (Q, cap, 64)
        K8 = cand.shape[1] * 8

        def field(f):
            return blk[:, :, f * 8:(f + 1) * 8].astype(
                jnp.float32).reshape(Q, K8)

        tc = _slab_soa((field(0), field(1), field(2)),
                       (field(3), field(4), field(5)),
                       ro_c, ri_c, t_min, t_max)            # (Q, cap*8)
        live_c = (tc < INF) & jnp.broadcast_to(
            live[:, :, None], live.shape + (8,)).reshape(Q, K8)
        cidx = (cand[:, :, None] * 8 + jnp.arange(8, dtype=jnp.int32)
                ).reshape(Q, K8)
        cap = cb.k_leaf if l == len(levels) - 1 else caps[l]
        cand, live, ovf = _compact_lanes(live_c, cidx, cap)
        overflow = overflow + ovf
        if collect is not None:
            collect.append((jnp.sum(live_c, axis=1, dtype=jnp.int32), ovf))
    return cand, live, overflow


def _flat_pairs(cand, live, Q: int, budget: int):
    """(Q, K) compacted candidates -> ray-sorted flat pair list (a 1-D
    stable sort, _flatten_live).  Returns (rayP (budget,), cidP (budget,),
    dropped scalar, cnt (Q,) pairs kept per ray, lost (Q,) pairs per ray
    dropped past the budget)."""
    arq = jnp.arange(Q, dtype=jnp.int32)
    key = jnp.where(live, arq[:, None], Q)
    rayP, cidP, dropped = _flatten_live(key.reshape(-1), cand.reshape(-1),
                                        budget, Q)
    cnt = jnp.sum(live.astype(jnp.int32), axis=1)       # (Q,)
    right = jnp.cumsum(cnt)
    base = right - cnt
    right_c = jnp.minimum(right, budget)
    cnt_c = jnp.maximum(right_c - jnp.minimum(base, budget), 0)
    return rayP, cidP, dropped, cnt_c, cnt - cnt_c


def _reduce_closest(rayP, t_p, g_p, u_p, v_p, cnt):
    """Per-ray nearest hit over a ray-major pair list.

    rayP (P,): ray id of each pair (sentinel Q past the live pairs); t_p,
    g_p, u_p, v_p: per-pair test results (t INF on miss); cnt (Q,): per-ray
    pair counts (from _flat_pairs).  The winner is the lowest t, ties broken
    by the LOWEST gid (SURVEY.md §4 item 2).  Returns (best_t (Q,), gid, u,
    v); rays without a hit get (INF, 0, 0, 0).

    Two-pass segment min (then a third for the winning pair's position):
    min is order-independent, so the scatter-min passes are deterministic
    whatever order the GPU's atomics run in.  On the H100 this beat a
    3-key sort of the pair list and a lax.associative_scan segmented min
    end to end (PERF.md); all three are bit-identical."""
    Q = cnt.shape[0]
    P = rayP.shape[0]
    seg_min = functools.partial(jax.ops.segment_min, segment_ids=rayP,
                                num_segments=Q + 1, indices_are_sorted=True)
    no_gid = jnp.int32(2**31 - 1)
    g_key = jnp.where(t_p < INF, g_p, no_gid)
    best_t = seg_min(t_p)                   # (Q+1,): row Q collects padding
    at_t = t_p == best_t[rayP]
    best_g = seg_min(jnp.where(at_t, g_key, no_gid))
    pos = seg_min(jnp.where(at_t & (g_key == best_g[rayP]),
                            jnp.arange(P, dtype=jnp.int32), P))
    win = jnp.clip(pos[:Q], 0, P - 1)
    best_t, best_g = best_t[:Q], best_g[:Q]
    has = (cnt > 0) & (best_t < INF)
    return (jnp.where(has, best_t, INF), jnp.where(has, best_g, 0),
            jnp.where(has, u_p[win], 0.0), jnp.where(has, v_p[win], 0.0))


def _reduce_anyhit(rayP, t_p, cnt):
    """Per-ray occlusion over a ray-major pair list: a ray is occluded iff
    any of its pairs hit (t_p < INF).  Arguments as in _reduce_closest;
    returns (Q,) bool."""
    Q = cnt.shape[0]
    hit = ((t_p < INF) & (rayP < Q)).astype(jnp.int32)
    n_hit = jax.ops.segment_max(hit, rayP, num_segments=Q + 1,
                                indices_are_sorted=True)[:Q]
    return (cnt > 0) & (n_hit > 0)


def pair_reduce_reference(rayP, t_p, g_p, u_p, v_p, Q: int):
    """Plain numpy reference of _reduce_closest + _reduce_anyhit (for the
    tests and the GPU smoke check): returns (best_t, gid, u, v, occluded)
    per ray, each pair list entry read independently of the others."""
    rayP, t_p, g_p = np.asarray(rayP), np.asarray(t_p), np.asarray(g_p)
    u_p, v_p = np.asarray(u_p), np.asarray(v_p)
    best_t = np.full(Q, INF, np.float32)
    best_g = np.zeros(Q, np.int32)
    best_u = np.zeros(Q, np.float32)
    best_v = np.zeros(Q, np.float32)
    hit = (rayP < Q) & (t_p < INF)
    idx = np.flatnonzero(hit)
    order = np.lexsort((g_p[idx], t_p[idx], rayP[idx]))
    rays, first = np.unique(rayP[idx][order], return_index=True)
    pick = idx[order][first]
    best_t[rays], best_g[rays] = t_p[pick], g_p[pick]
    best_u[rays], best_v[rays] = u_p[pick], v_p[pick]
    occ = np.zeros(Q, bool)
    occ[rays] = True
    return best_t, best_g, best_u, best_v, occ


def _retrace_suspects_closest(cb: ClusterBVH, ro, rd, t_min1, t_max1,
                              suspect, best):
    """Exact repair: re-trace rays whose candidates overflowed any static
    budget through the packed per-ray octant walk (exact by construction)
    and take ITS answer for those rays.  Non-suspect rays get t_max=-1
    (trivial miss) so the lock-step walk does no work for them; the whole
    repair is cond-gated so a clean batch pays only the predicate.  This
    turns the capacity contract from a correctness bound into a perf knob:
    overflow degrades to slower, never to a dropped hit."""
    from tpu_pt.bvh import packed as packed_mod

    best_t, best_g, best_u, best_v = best

    def repair(best):
        best_t, best_g, best_u, best_v = best
        t_max_f = jnp.where(suspect, t_max1, -1.0)
        bt, slot, bu, bv, _ = packed_mod._traverse(
            cb.fallback, ro, rd, t_min1[:, None], t_max_f[:, None],
            any_hit=False)
        found = bt[:, 0] < t_max_f
        gid = cb.fallback.prim_gid[slot]
        bt1 = jnp.where(found, bt[:, 0], INF)
        return (jnp.where(suspect, bt1, best_t),
                jnp.where(suspect, jnp.where(found, gid, 0), best_g),
                jnp.where(suspect, jnp.where(found, bu[:, 0], 0.0), best_u),
                jnp.where(suspect, jnp.where(found, bv[:, 0], 0.0), best_v))

    return jax.lax.cond(jnp.any(suspect), repair, lambda b: b,
                        (best_t, best_g, best_u, best_v))


def _retrace_suspects_anyhit(cb: ClusterBVH, ro, rd, t_min1, t_max1,
                             suspect, occ):
    from tpu_pt.bvh import packed as packed_mod

    def repair(occ):
        t_max_f = jnp.where(suspect, t_max1, -1.0)
        _, _, _, _, occ_fb = packed_mod._traverse(
            cb.fallback, ro, rd, t_min1[:, None], t_max_f[:, None],
            any_hit=True)
        return jnp.where(suspect, occ_fb[:, 0], occ)

    return jax.lax.cond(jnp.any(suspect), repair, lambda o: o, occ)


# Intra-batch traversal split: run the traversal as SPLIT independent
# sub-batches of Q/SPLIT rays each (narrower sorts and intermediates, and
# independent chains XLA can interleave).  Per-ray results are
# bit-identical (all stages reduce per ray); only the static pair budget is
# sliced per sub-batch, so truncation PATTERNS can differ — which the
# overflow counter reports and verify-then-retry repairs exactly, same as
# any other capacity miss.  4 (sub-batch width 1024) is a tuning constant
# not yet re-measured on the GPU (ROADMAP 1d); _split_batches keeps
# sub-batches >= 1024 rays so smaller queues degrade to fewer splits.
SPLIT_CLOSEST = 4
SPLIT_ANYHIT = 4

# Optional override for the any-hit pair budget multiplier (pairs per ray
# of static budget; None = use the BVH's pair_mults[2], same as closest).
ANYHIT_MULT: int | None = None


def _split_batches(Q: int, split: int) -> int:
    """Effective split factor: sub-batches must stay lane-aligned and wide
    enough that fixed per-stage costs don't dominate."""
    k = max(1, int(split))
    while k > 1 and (Q % k != 0 or Q // k < 1024):
        k //= 2
    return k


def _split_map(fn, k: int, *lanes):
    """Run ``fn`` over k STRIDED sub-batches (sub-batch i takes lanes i,
    i+k, ...) as one vmapped program, and put the per-lane outputs back in
    lane order.  fn returns per-lane arrays plus a trailing per-sub-batch
    scalar count, which is summed."""
    if k == 1:
        return fn(*lanes)

    def split(x):
        return x.reshape((x.shape[0] // k, k) + x.shape[1:]).swapaxes(0, 1)

    *per_lane, count = jax.vmap(fn)(*(split(x) for x in lanes))
    return (*(x.swapaxes(0, 1).reshape((-1,) + x.shape[2:])
              for x in per_lane), jnp.sum(count))


def _traverse_compact(cb: ClusterBVH, ro, rd, t_min, t_max,
                      suspect_out: list | None = None):
    """Closest hit: sort-free descent + one flat all-candidates pair batch
    + per-ray reduce.  No while_loop, no best-t feedback — exact because
    every live candidate is tested.  Returns (best_t (Q,1), gid, u, v,
    overflow count).

    Sub-batches are STRIDED (sub-batch i takes lanes i, i+k, ...), not
    contiguous: wavefront respawn fills lanes in pixel order, so
    contiguous slices concentrate coherent hot blocks and blow the
    per-sub-batch pair budget (29,763 truncations on the headline bench
    with contiguous quarters vs 0 unsplit).  Round-robin lanes give every
    slice a statistically identical mix — same load-balance argument as
    dist.sharding's pixel interleaving.  The sub-batches run as one vmapped
    program (one copy of the traversal in the compiled program).

    suspect_out: observability hook — when a list is passed, the per-ray
    suspect mask (this ray's candidates overflowed some static budget) is
    appended; the basis of suspect-pixel-only repair (VERDICT r5 task 6).
    """
    k = _split_batches(ro.shape[0], SPLIT_CLOSEST)
    t_min1, t_max1 = t_min[:, 0], t_max[:, 0]
    best_t, best_g, best_u, best_v, suspect, n_ovf = _split_map(
        functools.partial(_traverse_compact_1, cb), k, ro, rd, t_min1,
        t_max1)
    if cb.fallback is not None:
        best_t, best_g, best_u, best_v = _retrace_suspects_closest(
            cb, ro, rd, t_min1, t_max1, suspect,
            (best_t, best_g, best_u, best_v))
    if suspect_out is not None:
        suspect_out.append(suspect)
    return best_t[:, None], best_g, best_u[:, None], best_v[:, None], n_ovf


def _traverse_compact_1(cb: ClusterBVH, ro, rd, t_min1, t_max1):
    """One closest-hit sub-batch: (best_t, gid, u, v, suspect, overflow)."""
    Q = ro.shape[0]
    cand, live, ovf = _descend_compact(cb, ro, 1.0 / rd, t_min1[:, None],
                                       t_max1[:, None])
    budget = int(cb.pair_mults[2] * Q)
    rayP, cidP, dropped, cnt, lost = _flat_pairs(cand, live, Q,
                                                        budget)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, jnp.minimum(rayP, Q - 1), cidP,
        rayP < Q)
    return (*_reduce_closest(rayP, t_p, g_p, u_p, v_p, cnt),
            (ovf > 0) | (lost > 0), jnp.sum(ovf) + dropped)


def _traverse_compact_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max,
                             suspect_out: list | None = None,
                             narrow: bool = False):
    """Occlusion: any tested pair with a hit in range occludes its ray.
    Strided sub-batches as in _traverse_compact.  Returns ((Q,) bool,
    overflow count).

    Any-hit pair budget: callers that KNOW the batch is a steady-state
    shadow wave (the wavefront loop body after its wide warm-up prefix)
    pass narrow=True for the pair_mults[3] budget (~2/3 of the closest
    stage's: shadow batches are half-occupied in steady state); all other
    calls use the wide pair_mults[2] budget, which also covers the
    fully-occupied wide-angle first-wave shadows (884 step-0 truncations at
    128² under the narrow budget).  A runtime lax.cond ladder between the
    two widths pays for both branches, hence this static caller-side split.
    The ANYHIT_MULT A/B knob overrides both."""
    if ANYHIT_MULT is not None:
        mult = ANYHIT_MULT
    elif narrow and len(cb.pair_mults) > 3:
        mult = cb.pair_mults[3]
    else:
        mult = cb.pair_mults[2]
    k = _split_batches(ro.shape[0], SPLIT_ANYHIT)
    t_min1, t_max1 = t_min[:, 0], t_max[:, 0]
    occ, suspect, n_ovf = _split_map(
        functools.partial(_traverse_compact_anyhit_1, cb, mult), k, ro, rd,
        t_min1, t_max1)
    if cb.fallback is not None:
        occ = _retrace_suspects_anyhit(cb, ro, rd, t_min1, t_max1, suspect,
                                       occ)
    if suspect_out is not None:
        suspect_out.append(suspect)
    return occ, n_ovf


def _traverse_compact_anyhit_1(cb: ClusterBVH, mult, ro, rd, t_min1,
                               t_max1):
    """One any-hit sub-batch: (occluded, suspect, overflow)."""
    Q = ro.shape[0]
    cand, live, ovf = _descend_compact(cb, ro, 1.0 / rd, t_min1[:, None],
                                       t_max1[:, None])
    rayP, cidP, dropped, cnt, lost = _flat_pairs(cand, live, Q,
                                                        int(mult * Q))
    t_p, _, _, _ = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, jnp.minimum(rayP, Q - 1), cidP,
        rayP < Q)
    return (_reduce_anyhit(rayP, t_p, cnt), (ovf > 0) | (lost > 0),
            jnp.sum(ovf) + dropped)


def compact_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Observability for the compact path (capacity contract, r2 form).

    Returns (n_live_pairs, n_overflow) where n_overflow counts candidates
    truncated ANYWHERE: descent frontier caps (including the k_leaf lane
    cap) plus flat-pair-budget drops.  The compact traversal is exact iff
    n_overflow == 0 for the scene/ray population — asserted in CI on the
    bench scenes (tests/test_cluster.py)."""
    cb = jax.tree.map(jnp.asarray, cb)
    t_min1 = t_min[:, 0] if t_min.ndim == 2 else t_min
    t_max1 = t_max[:, 0] if t_max.ndim == 2 else t_max
    Q = ro.shape[0]
    cand, live, overflow = _descend_compact(
        cb, ro, 1.0 / rd, t_min1[:, None], t_max1[:, None])
    budget = int(cb.pair_mults[2] * Q)
    rayP, _, dropped, _, _ = _flat_pairs(cand, live, Q, budget)
    n_live = jnp.sum((rayP < Q).astype(jnp.int32))
    return n_live, jnp.sum(overflow) + dropped


# Traversal mode: "compact" (production: sort-free mask-compaction descent
# + one flat all-candidates pair batch), "frontier" (per-ray t-sorted
# frontier + best-t feedback rounds) or "pairs" (flat pair-major walk —
# 1-D sorts at every level).
TRAVERSAL_MODE = "compact"

# Gather the descent's child AABBs from the bf16 outward-rounded tables
# (half the block-gather bytes; candidate selection stays exact because
# rounding is conservative).
GATHER_BF16 = True


def intersect_counted(cb: ClusterBVH, scene: Scene, ro, rd, t_min, t_max,
                      suspect_out: list | None = None):
    """Nearest hit + the capacity-contract overflow count for this call
    (candidates truncated by frontier caps / k_leaf / the flat pair
    budget).  The traversal is exact iff the count is 0; production
    renders surface the summed count (wavefront counts, bench JSON, CLI)
    instead of silently dropping hits — SURVEY.md §5 metrics.

    suspect_out: when a list is passed, the per-ray suspect mask is
    appended (always, even for the always-exact modes, where it is all
    False) — the input of suspect-pixel repair."""
    cb = jax.tree.map(jnp.asarray, cb)
    t_max_b = jnp.broadcast_to(t_max, (ro.shape[0], 1))
    if TRAVERSAL_MODE == "compact":
        best_t, gid, u, v, ovf = _traverse_compact(cb, ro, rd, t_min,
                                                   t_max_b,
                                                   suspect_out=suspect_out)
        suspect_out = None  # filled by the traversal
    elif TRAVERSAL_MODE == "pairs":
        best_t, gid, u, v, ovf = _traverse_pairs(cb, ro, rd, t_min, t_max_b)
    else:
        best_t, gid, u, v, ovf = _traverse(cb, scene, ro, rd, t_min,
                                           t_max_b)
    if suspect_out is not None:  # non-compact modes: no per-ray truncation
        suspect_out.append(jnp.zeros((ro.shape[0],), bool))
    found = best_t < t_max_b
    return Hit(hit=found, t=jnp.where(found, best_t, INF), prim=gid,
               u=u, v=v), ovf


def intersect(cb: ClusterBVH, scene: Scene, ro, rd, t_min, t_max) -> Hit:
    return intersect_counted(cb, scene, ro, rd, t_min, t_max)[0]


def occluded_counted(cb: ClusterBVH, scene: Scene, ro, rd, t_max,
                     suspect_out: list | None = None,
                     narrow: bool = False):
    """Occlusion + overflow count (see intersect_counted)."""
    cb = jax.tree.map(jnp.asarray, cb)
    t_min = jnp.zeros((ro.shape[0], 1), jnp.float32)
    t_max = jnp.broadcast_to(t_max, (ro.shape[0], 1))
    if TRAVERSAL_MODE == "compact":
        occ, ovf = _traverse_compact_anyhit(cb, ro, rd, t_min, t_max,
                                            suspect_out=suspect_out,
                                            narrow=narrow)
        suspect_out = None
    elif TRAVERSAL_MODE == "pairs":
        occ, ovf = _traverse_pairs_anyhit(cb, ro, rd, t_min, t_max)
    else:
        occ, ovf = _traverse_anyhit(cb, ro, rd, t_min, t_max)
    if suspect_out is not None:
        suspect_out.append(jnp.zeros((ro.shape[0],), bool))
    return occ[:, None], ovf


def occluded(cb: ClusterBVH, scene: Scene, ro, rd, t_max):
    return occluded_counted(cb, scene, ro, rd, t_max)[0]


def level_hit_counts(cb: ClusterBVH, ro, rd):
    """(Q, n_levels) i32 — how many node AABBs of each level every ray
    truly intersects (dense, no frontier truncation).  This IS the frontier
    width each ray needs at that level (a child hit implies its parent
    hit), so it sizes the capacity contract from data."""
    rd_inv = 1.0 / rd
    Q = ro.shape[0]
    t_min = jnp.zeros((Q, 1), jnp.float32)
    t_max = jnp.full((Q, 1), INF, jnp.float32)
    counts = []
    for lv in cb.levels:
        # Chunk wide levels to bound the (Q, N) temporary.
        n = lv.shape[0]
        chunk = 2048
        tot = jnp.zeros((Q,), jnp.int32)
        for s in range(0, n, chunk):
            blk = lv[s:s + chunk]
            te = _slab(blk[None, :, 0:3], blk[None, :, 3:6],
                       ro[:, None, :], rd_inv[:, None, :], t_min, t_max)
            tot = tot + jnp.sum(te < INF, axis=1, dtype=jnp.int32)
        counts.append(tot)
    return jnp.stack(counts, axis=1)


def autotune_frontiers(scene: Scene, ro, rd, slack: float = 1.5,
                       tile: int = TILE, dense_start: int = 512,
                       pair_budget: int | None = None) -> ClusterBVH:
    """Build a ClusterBVH whose frontier caps are sized from MEASURED
    per-level hit counts of the given sample rays (max over rays x slack),
    instead of the grid heuristic — tighter caps mean smaller sorts and
    fewer block gathers, with the overflow risk quantified by the sample.
    Sample rays should cover the workload; prefer autotune_for_render,
    which probes the REAL wavefront population instead of a proxy.
    """
    cb = build_cluster_bvh(scene, tile=tile, dense_start=dense_start)
    counts = np.asarray(level_hit_counts(jax.tree.map(jnp.asarray, cb),
                                         jnp.asarray(ro), jnp.asarray(rd)))
    caps = []
    for l, lv in enumerate(cb.levels):
        need = int(counts[:, l].max())
        caps.append(int(min(lv.shape[0], max(8, round(need * slack)))))
    # The compact path's flat pair budget is SHARED across the batch
    # (pair_mults[-1] x Q slots).  r3 sized it from the MEAN per-ray hits,
    # which the real mixed-depth wavefront falsified (BENCH_AUTOTUNE=1
    # truncated 171k candidates, VERDICT r3 weak #1): a batch of Q rays can
    # ALL be coherent-high at once.  Sized from the max like the caps.
    max_leaf_hits = float(counts[:, -1].max())
    leaf_mult = max(4, int(np.ceil(max_leaf_hits * slack)))
    pair_mults = (8, 8, leaf_mult)
    return build_cluster_bvh(scene, tile=tile, frontiers=tuple(caps),
                             k_leaf=caps[-1], pair_budget=pair_budget,
                             dense_start=dense_start, pair_mults=pair_mults)


def attach_fallback(cb: ClusterBVH, scene: Scene,
                    max_leaf: int = 4) -> ClusterBVH:
    """Return a copy of ``cb`` carrying the exact-retrace fallback (a
    PackedBVH): any ray whose candidates overflow a static budget is
    re-traced through the exact per-ray octant walk, so truncation can
    only cost time, never hits."""
    from tpu_pt.bvh.native import build_packed

    return ClusterBVH(cb.levels, cb.tiles, cb.tile_gid, cb.frontiers,
                      cb.k_leaf, cb.pair_budget, pair_mults=cb.pair_mults,
                      levels16=cb.levels16,
                      fallback=build_packed(scene, max_leaf=max_leaf))


def autotune_for_render(scene: Scene, cam, cfg, queue: int = 4096,
                        segments: int = 8, warm_steps: int = 6,
                        probe_steps: int = 10, slack: float = 1.3,
                        tile: int = TILE, dense_start: int = 512,
                        pair_budget: int | None = None,
                        exact_fallback: bool = True) -> ClusterBVH:
    """Size the capacity contract from the REAL wavefront population.

    r3's tuner sampled camera + random interior rays and sized the pair
    budget from the mean; the actual mixed-depth wavefront falsified both
    (VERDICT r3: 171k truncated candidates, -3.3% image energy).  This one
    runs the production ``wavefront._step`` itself — ``segments`` short
    runs starting at strided pixel offsets so the whole image contributes —
    on a DOUBLED-cap probe BVH (so measured need is not clipped by the caps
    being measured), records per level the max per-ray candidate width and
    the max batch-total live pairs over every closest-hit AND shadow batch,
    and rebuilds with caps = measured max x ``slack``.  With
    ``exact_fallback`` the result also carries the packed-walk retrace, so
    even a population outside the probed envelope only costs time.
    """
    from tpu_pt.render import wavefront as W
    from tpu_pt.render.driver import _intersectors_counted

    # Probe at a bounded resolution: per-ray frontier widths are a per-ray
    # geometric property independent of pixel count, so a ≤512² probe
    # sees the same populations as the full render at a fraction of the
    # cost
    # (camera still spans the full field of view; strided segments still
    # cover the whole image).  Pair budgets are sized from per-SLICE
    # maxima below, which are pixel-decorrelated at any resolution, so no
    # extra coherence margin is needed when probing below render size.
    if cfg.n_pixels > 512 * 512:
        scale = (cfg.n_pixels / (512 * 512)) ** 0.5
        cfg = cfg.replace(width=max(1, round(cfg.width / scale)),
                          height=max(1, round(cfg.height / scale)))
    cb0 = build_cluster_bvh(scene, tile=tile, dense_start=dense_start)
    wide_caps = tuple(min(lv.shape[0], 2 * c)
                      for lv, c in zip(cb0.levels, cb0.frontiers))
    probe_cb = build_cluster_bvh(
        scene, tile=tile, dense_start=dense_start, frontiers=wide_caps,
        k_leaf=wide_caps[-1],
        pair_mults=(cb0.pair_mults[0], cb0.pair_mults[1],
                    2 * cb0.pair_mults[2]))
    scene_d = jax.device_put(scene)
    probe_d = jax.device_put(probe_cb)
    ifn, ofn = _intersectors_counted("cluster", probe_d)
    key = jax.random.key(7)
    L = len(probe_cb.levels)
    n_pix = cfg.n_pixels
    Q = min(queue, n_pix * cfg.spp)

    @jax.jit
    def probe_segment(pix_lo, n_pix_local):
        st = W.init_queue(Q, n_pix)
        # Measure from the FIRST step (no unmeasured warm prefix): the
        # step-0 shadow wave is fully occupied and wide-angle coherent —
        # the binding any-hit population at small images (r5: 884
        # truncations missed by a warmed-only probe) — while later steps
        # supply the mixed-depth population; the max covers both.

        def body(carry, step_i):
            s, need_max, pair_max = carry
            probes = []
            s, _ = W._step(scene_d, cam, cfg, key, ifn, ofn, s, pix_lo,
                           n_pix_local, jnp.int32(0), cfg.spp,
                           ray_probe=probes)
            for j, (ro, rd, t_max) in enumerate(probes):
                collect = []
                _, live, _ = _descend_compact(
                    probe_d, ro, 1.0 / rd, jnp.zeros_like(t_max), t_max,
                    collect=collect)
                need = jnp.stack([jnp.max(n) for n, _ in collect])
                need_max = jnp.maximum(need_max, need)
                # Pair sizing mirrors the production budget structure:
                # slot 0 sizes the WIDE budget (pair_mults[2]): closest
                # batches of every step PLUS shadow batches of the first
                # waves (the wavefront's unrolled wide prefix serves
                # those).  Slot 1 sizes the NARROW any-hit budget
                # (pair_mults[3]): shadow batches AFTER the prefix only.
                # The budget applies PER STRIDED SUB-BATCH in production
                # (SPLIT_CLOSEST/SPLIT_ANYHIT), so size from the max
                # per-slice pair sum (whole-batch totals carry ~1.4x
                # coherent-peak inflation that strided slices flatten).
                ks = _split_batches(live.shape[0],
                                    SPLIT_CLOSEST if j == 0 else
                                    SPLIT_ANYHIT)
                per_ray = jnp.max(jnp.stack([
                    jnp.sum(live[i::ks], dtype=jnp.int32)
                    for i in range(ks)])) * ks
                if j == 0:
                    pair_max = pair_max.at[0].max(per_ray)
                else:
                    in_prefix = step_i < W.WIDE_PREFIX_STEPS
                    pair_max = pair_max.at[0].max(
                        jnp.where(in_prefix, per_ray, 0))
                    pair_max = pair_max.at[1].max(
                        jnp.where(in_prefix, 0, per_ray))
            return (s, need_max, pair_max), None

        (_, need_max, pair_max), _ = jax.lax.scan(
            body, (st, jnp.zeros((L,), jnp.int32),
                   jnp.zeros((2,), jnp.int32)),
            jnp.arange(warm_steps + probe_steps))
        return need_max, pair_max

    need_max = np.zeros((L,), np.int64)
    pair_max = np.zeros((2,), np.int64)
    for i in range(segments):
        lo = (n_pix // segments) * i
        nm, pm = probe_segment(jnp.int32(lo), jnp.int32(n_pix - lo))
        need_max = np.maximum(need_max, np.asarray(nm))
        pair_max = np.maximum(pair_max, np.asarray(pm))

    caps = tuple(
        int(min(lv.shape[0], max(8, int(np.ceil(n * slack)) + 2)))
        for lv, n in zip(probe_cb.levels, need_max))
    # Pair budgets get a THINNER margin than the frontier caps: they are
    # the dominant runtime cost of over-provisioning (every budgeted pair
    # slot is tile-tested whether live or dead), and the
    # exact fallback + verify-then-retry make a thin margin safe: an
    # out-of-envelope batch degrades to slower, never to wrong.
    # No extra coherence factor on top: the per-slice maxima already
    # reflect what a production sub-batch carries (strided slices are
    # pixel-decorrelated at any resolution).
    pair_slack = min(slack, 1.05)
    leaf_mult = max(2, int(np.ceil(pair_max[0] * pair_slack / Q)))
    anyhit_mult = max(2, int(np.ceil(pair_max[1] * pair_slack / Q)))
    tuned = build_cluster_bvh(
        scene, tile=tile, dense_start=dense_start, frontiers=caps,
        k_leaf=caps[-1], pair_budget=pair_budget,
        pair_mults=(cb0.pair_mults[0], cb0.pair_mults[1], leaf_mult,
                    anyhit_mult))
    return attach_fallback(tuned, scene) if exact_fallback else tuned


def autotune_for_camera(scene: Scene, cam, width: int, height: int,
                        slack: float = 1.5,
                        pair_budget: int | None = None,
                        queue: int = 4096) -> ClusterBVH:
    """Back-compat wrapper: autotune_for_render with a default path-tracing
    config at the given resolution (4 bounces + RR — the standard render
    workload).  Used by the CLI --autotune flag.  (The r3-era ``n``/``seed``
    sampling knobs are gone: the warm-wavefront tuner probes the real
    render population, not a random ray sample — ADVICE r4.)"""
    from tpu_pt.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    return autotune_for_render(scene, cam, cfg, queue=queue, slack=slack,
                               pair_budget=pair_budget)


def candidate_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Observability: (per-ray candidate count, per-ray truncation count).
    Truncation > 0 means the static frontier/K knobs are too small for this
    scene/ray set (SURVEY.md §5 metrics)."""
    rd_inv = 1.0 / rd
    cand, cand_t, overflow = _descend(
        cb, ro, rd_inv, t_min[:, None] if t_min.ndim == 1 else t_min,
        t_max[:, None] if t_max.ndim == 1 else t_max)
    return jnp.sum(cand_t < INF, axis=1), overflow
