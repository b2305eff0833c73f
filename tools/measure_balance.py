"""Measure multi-chip load balance on the virtual 8-device CPU mesh.

SURVEY.md §2 r15 lists the reference's *dynamic* master/worker tile
assignment as a first-class capability; VERDICT r1–r3 asked for the
measurement that either justifies this repo's static split or motivates a
mitigation.  This tool renders the atrium interior (heterogeneous tiles:
bright skylit nave vs dark colonnade aisles — the worst case for
contiguous-block splits) both ways and reports the per-shard executed-step
and path-segment spread.

The drain tail is the irreducible cost: even a perfectly balanced shard
idles while the slowest shard finishes its last partial queue, bounded by
~max_depth extra steps.

Run: PYTHONPATH=. python tools/measure_balance.py   (CPU; conftest-style 8-dev mesh)
Knobs: MB_SIZE (256), MB_SPP (1), MB_QUEUE (2048), MB_SCENE (atrium).
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tpu_pt.bvh import cluster as C  # noqa: E402
from tpu_pt.config import RenderConfig  # noqa: E402
from tpu_pt.dist.sharding import make_mesh, render_sharded  # noqa: E402
from tpu_pt.scene import meshes  # noqa: E402


def main():
    size = int(os.environ.get("MB_SIZE", "256"))
    spp = int(os.environ.get("MB_SPP", "1"))
    queue = int(os.environ.get("MB_QUEUE", "2048"))
    scene_name = os.environ.get("MB_SCENE", "atrium")
    if scene_name == "atrium":
        scene = meshes.atrium_scene()
        cam = meshes.atrium_camera(size, size)
    else:
        subdiv = {"big": 7, "big-1m": 8}[scene_name]
        scene = meshes.big_scene(subdiv=subdiv)
        cam = meshes.big_camera(size, size)
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    # Exact fallback: the atrium overflows the grid-heuristic default caps
    # (by design), and truncation depends on how rays are batched — WITHOUT
    # the exact repair the two layouts would drop different hits and the
    # bit-identity check below would be meaningless.
    cb = C.attach_fallback(C.build_cluster_bvh(scene), scene)
    mesh = make_mesh()
    key = jax.random.key(0)

    ref = None
    for mode, interleave in (("contiguous ", False), ("interleaved", True)):
        img, stats = render_sharded(scene, cam, cfg, key, cb, mesh,
                                    queue=queue, backend="cluster",
                                    interleave=interleave, with_stats=True)
        if ref is None:
            ref = np.asarray(img)
        else:
            assert np.array_equal(ref, np.asarray(img)), \
                "interleaved layout must be bit-identical"
        steps = stats["steps_run"]
        segs = stats["n_closest"]
        imb = (steps.max() - steps.min()) / max(1.0, steps.mean())
        print(f"{mode}: steps/shard min={steps.min()} max={steps.max()} "
              f"mean={steps.mean():.1f} imbalance=(max-min)/mean="
              f"{imb * 100:.1f}%")
        print(f"    closest segs/shard min={segs.min()} max={segs.max()} "
              f"spread={(segs.max() - segs.min()) / segs.mean() * 100:.1f}%"
              f"   overflow={stats['n_overflow'].sum()}")
        # Drain tail: steps the busiest shard runs beyond the ideal
        # (total_segments / (Q * n_shards)) lower bound.
        n = len(steps)
        ideal = segs.sum() / (queue * n)
        print(f"    drain tail: max-steps {steps.max()} vs ideal "
              f"{ideal:.1f} (+{steps.max() - ideal:.1f} steps)")
    print("images bit-identical across layouts: OK")


if __name__ == "__main__":
    main()
