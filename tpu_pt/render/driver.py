"""Render drivers: turn the integrator into images.

Counterpart of the reference's ``PathTracer::start_raytracing`` tile
scheduler (SURVEY.md §2 row 13) — but instead of worker threads pulling
32×32 tiles from a mutex-guarded queue, the image is a flat array of
(pixel, sample) pairs processed in fixed-size jitted chunks (static shapes;
the chunk size is the memory knob).  Tile scheduling across *chips* lives in
``tpu_pt/dist`` (shard_map), not here.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.config import RenderConfig
from tpu_pt.render import brute
from tpu_pt.render.integrator import render_chunk
from tpu_pt.scene.types import Scene


def _intersectors(backend: str, bvh=None):
    if backend == "brute":
        return brute.intersect, brute.occluded
    if backend == "bvh":
        from tpu_pt.bvh import flat

        if bvh is None:
            raise ValueError("backend='bvh' requires a built FlatBVH")
        return (
            functools.partial(flat.intersect, bvh),
            functools.partial(flat.occluded, bvh),
        )
    if backend == "cluster":
        from tpu_pt.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        return (
            functools.partial(cluster_mod.intersect, bvh),
            functools.partial(cluster_mod.occluded, bvh),
        )
    if backend == "packed":
        from tpu_pt.bvh import packed as packed_mod

        if bvh is None:
            raise ValueError("backend='packed' requires a PackedBVH")
        return (
            functools.partial(packed_mod.intersect, bvh),
            functools.partial(packed_mod.occluded, bvh),
        )
    raise ValueError(f"unknown backend {backend!r}")


def _intersectors_counted(backend: str, bvh=None):
    """Like _intersectors, but each call ALSO returns the capacity-contract
    overflow count (candidates silently truncated by static budgets).  The
    cluster backend reports real counts; every other backend is exact by
    construction and returns a constant 0.  The wavefront renderer sums
    these per step so production renders surface truncation instead of
    silently dropping hits (SURVEY.md §5 metrics; VERDICT r2 task 4)."""
    if backend == "cluster":
        from tpu_pt.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        return (
            functools.partial(cluster_mod.intersect_counted, bvh),
            functools.partial(cluster_mod.occluded_counted, bvh),
        )
    isect, occl = _intersectors(backend, bvh)

    def isect_c(scene, ro, rd, t_min, t_max):
        return isect(scene, ro, rd, t_min, t_max), jnp.int32(0)

    def occl_c(scene, ro, rd, t_max, narrow=False):
        del narrow  # exact backends have no pair budget
        return occl(scene, ro, rd, t_max), jnp.int32(0)

    return isect_c, occl_c


def _intersectors_suspect(backend: str, bvh=None):
    """Like _intersectors_counted, but each call also returns the per-ray
    SUSPECT mask (this ray's candidates overflowed a static budget, so its
    result may have dropped a hit).  Exact-by-construction backends return
    all-False.  Feeds suspect-pixel-only repair (VERDICT r5 task 6)."""
    if backend == "cluster":
        from tpu_pt.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")

        def isect_s(scene, ro, rd, t_min, t_max):
            sus = []
            hit, novf = cluster_mod.intersect_counted(
                bvh, scene, ro, rd, t_min, t_max, suspect_out=sus)
            return hit, novf, sus[0]

        def occl_s(scene, ro, rd, t_max, narrow=False):
            sus = []
            occ, novf = cluster_mod.occluded_counted(
                bvh, scene, ro, rd, t_max, suspect_out=sus, narrow=narrow)
            return occ, novf, sus[0]

        return isect_s, occl_s
    isect_c, occl_c = _intersectors_counted(backend, bvh)

    def isect_s(scene, ro, rd, t_min, t_max):
        hit, novf = isect_c(scene, ro, rd, t_min, t_max)
        return hit, novf, jnp.zeros((ro.shape[0],), bool)

    def occl_s(scene, ro, rd, t_max, narrow=False):
        occ, novf = occl_c(scene, ro, rd, t_max, narrow=narrow)
        return occ, novf, jnp.zeros((ro.shape[0],), bool)

    return isect_s, occl_s


@functools.partial(jax.jit, static_argnames=("cfg", "backend"))
def _chunk_jit(scene, cam, cfg, key, pixel_ids, sample_ids, backend, bvh):
    isect, occl = _intersectors(backend, bvh)
    return render_chunk(scene, cam, cfg, key, pixel_ids, sample_ids, isect, occl)


def render(
    scene: Scene,
    cam,
    cfg: RenderConfig,
    key,
    backend: str = "brute",
    bvh=None,
    pix_chunk: Optional[int] = None,
):
    """Render to a (H, W, 3) linear-radiance image (row 0 = bottom row).

    Chunked megakernel-style driver: each chunk is ``pix_chunk`` whole pixels
    × ``spp`` samples, so the per-chunk output reduces to pixel means with no
    scatter.  The wavefront renderer (tpu_pt/render/wavefront.py) is the
    performance path; this one is the reference/debug path and the oracle.
    """
    n_pix = cfg.n_pixels
    if pix_chunk is None:
        if backend == "brute":
            budget = 1 << 22  # ray×prim pairs resident at once
            pix_chunk = max(1, budget // max(1, cfg.spp * scene.n_prims))
        else:
            pix_chunk = max(1, (1 << 17) // cfg.spp)
        pix_chunk = min(pix_chunk, n_pix)

    n_chunks = -(-n_pix // pix_chunk)
    img = np.zeros((n_pix, 3), np.float32)
    spp_ids = jnp.tile(jnp.arange(cfg.spp, dtype=jnp.int32), pix_chunk)
    for c in range(n_chunks):
        start = c * pix_chunk
        ids = np.arange(start, start + pix_chunk, dtype=np.int32)
        ids = np.minimum(ids, n_pix - 1)  # tail padding re-renders last pixel
        pixel_ids = jnp.repeat(jnp.asarray(ids), cfg.spp)
        L = _chunk_jit(scene, cam, cfg, key, pixel_ids, spp_ids, backend, bvh)
        L = L.reshape(pix_chunk, cfg.spp, 3).mean(axis=1)
        end = min(start + pix_chunk, n_pix)
        img[start:end] = np.asarray(L)[: end - start]
    return img.reshape(cfg.height, cfg.width, 3)
