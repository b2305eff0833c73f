"""Host-side binned-SAH BVH builder → flat skip-pointer layout.

Counterpart of the reference's ``BVHAccel::BVHAccel`` top-down SAH build +
the CUDA path's "flatten BVH → linear node array (child indices, not
pointers)" upload step (SURVEY.md §2 row 9, §3.2).  The twist: nodes are
emitted in DFS order with a *skip pointer* (escape index), so traversal is
stackless — each ray carries only one node cursor, which is what lets the
XLA traversal run thousands of rays in lockstep with no per-lane
stack (SURVEY.md §7 step 2, hard-part 1).

Layout invariants (tests/test_bvh.py checks these):
  - node 0 is the root; an inner node's first (left) child is node i+1 in
    the flat array;
  - ``skip[i]`` is the next DFS node when the AABB test misses (or after a
    leaf's primitives are tested); skip of the last DFS node == N (= done);
  - leaves have ``prim_count > 0`` and reference ``prim_ids[start:start+count]``,
    a permutation chunk of the global primitive index space
    ([0,T) triangles, [T,T+S) spheres);
  - every primitive appears in exactly one leaf;
  - parent AABBs contain child AABBs.

The device LBVH builder (tpu_pt/bvh/lbvh.py) emits the SAME layout so the
traversal kernels are backend-agnostic.  A C++ builder (native/) can slot in
for very large host builds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from tpu_pt.scene.types import Scene

MAX_LEAF = 4
N_BINS = 16


class FlatBVH(NamedTuple):
    node_min: jnp.ndarray    # (N, 3) f32
    node_max: jnp.ndarray    # (N, 3) f32
    skip: jnp.ndarray        # (N,) i32 — escape index; N == traversal done
    prim_start: jnp.ndarray  # (N,) i32 — into prim_ids (leaves only)
    prim_count: jnp.ndarray  # (N,) i32 — 0 for inner nodes
    prim_ids: jnp.ndarray    # (P,) i32 — permuted global primitive ids

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]


def prim_bounds(scene: Scene):
    """(P, 3) mins/maxs for the combined triangle+sphere index space."""
    v = np.asarray(scene.vertices)
    ti = np.asarray(scene.tri_idx)
    p0, p1, p2 = v[ti[:, 0]], v[ti[:, 1]], v[ti[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    c = np.asarray(scene.sph_center)
    r = np.asarray(scene.sph_radius)[:, None]
    lo = np.concatenate([tri_min, c - r], axis=0)
    hi = np.concatenate([tri_max, c + r], axis=0)
    return lo.astype(np.float32), hi.astype(np.float32)


def _sah_split(ids, lo, hi, cent):
    """Choose a binned-SAH split.  Returns (left_ids, right_ids)."""
    count = len(ids)
    c = cent[ids]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        half = count // 2
        return ids[:half], ids[half:]
    rel = (c[:, axis] - cmin[axis]) / ext[axis]
    bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
    counts = np.bincount(bins, minlength=N_BINS)
    # Per-bin AABBs via segmented min/max.
    bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
    bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
    np.minimum.at(bin_lo, bins, lo[ids])
    np.maximum.at(bin_hi, bins, hi[ids])

    def sa(lo_a, hi_a):
        d = np.maximum(hi_a - lo_a, 0.0)
        return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

    pre_lo = np.minimum.accumulate(bin_lo, axis=0)
    pre_hi = np.maximum.accumulate(bin_hi, axis=0)
    suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    pre_n = np.cumsum(counts)
    nl = pre_n[:-1].astype(np.float64)
    nr = count - nl
    cost = sa(pre_lo[:-1], pre_hi[:-1]) * nl + sa(suf_lo[1:], suf_hi[1:]) * nr
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    s_best = int(np.argmin(cost))
    if not np.isfinite(cost[s_best]):
        half = count // 2
        part = np.argsort(c[:, axis], kind="stable")
        return ids[part[:half]], ids[part[half:]]
    mask = bins <= s_best
    return ids[mask], ids[~mask]


def build_bvh(scene: Scene, max_leaf: int = MAX_LEAF) -> FlatBVH:
    lo, hi = prim_bounds(scene)
    n = lo.shape[0]
    cent = (lo + hi) * 0.5
    prim_perm = np.empty(n, dtype=np.int32)

    # Build directly in DFS pre-order with an explicit stack: when we pop a
    # node we emit its header at index len(out); pushing RIGHT before LEFT
    # guarantees the left subtree is emitted contiguously at parent+1, so
    # "inner hit → i+1" holds by construction.  Skip targets are patched
    # once the subtree size is known: we record each emitted node's parent
    # chain implicitly by emitting skip after the subtree completes.
    out_lo, out_hi = [], []
    out_start, out_count = [], []
    pending_skip = []  # (node_index,) to patch when its subtree is done

    # Each stack item: ("node", ids, offset) or ("patch", node_index).
    stack = [("node", np.arange(n, dtype=np.int32), 0)]
    skip_fix = []
    while stack:
        item = stack.pop()
        if item[0] == "patch":
            # Subtree of node item[1] just finished emitting; its skip is
            # the next emission index.
            skip_fix.append((item[1], len(out_lo)))
            continue
        _, ids, off = item
        idx = len(out_lo)
        out_lo.append(lo[ids].min(axis=0))
        out_hi.append(hi[ids].max(axis=0))
        if len(ids) <= max_leaf:
            out_start.append(off)
            out_count.append(len(ids))
            prim_perm[off:off + len(ids)] = ids
            skip_fix.append((idx, None))  # filled as idx_next after loop
            continue
        out_start.append(0)
        out_count.append(0)
        left_ids, right_ids = _sah_split(ids, lo, hi, cent)
        stack.append(("patch", idx))
        stack.append(("node", right_ids, off + len(left_ids)))
        stack.append(("node", left_ids, off))

    n_nodes = len(out_lo)
    skip = np.empty(n_nodes, np.int32)
    for idx, target in skip_fix:
        if target is None:
            # Leaf: skip = next DFS index (its own index + 1).
            skip[idx] = idx + 1
        else:
            skip[idx] = target

    return FlatBVH(
        node_min=np.asarray(out_lo, np.float32),
        node_max=np.asarray(out_hi, np.float32),
        skip=skip,
        prim_start=np.asarray(out_start, np.int32),
        prim_count=np.asarray(out_count, np.int32),
        prim_ids=prim_perm,
    )
