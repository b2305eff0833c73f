"""Observability subsystem tests (SURVEY.md §5 metrics/logging)."""

import json

import jax
import numpy as np

from tpu_pt.bvh.native import build_packed
from tpu_pt.config import RenderConfig
from tpu_pt.render.metrics import (
    RenderReport, bvh_stats, queue_occupancy, scene_stats,
)
from tpu_pt.scene import cornell


def test_scene_and_bvh_stats():
    scene = cornell.cornell("spheres")
    packed = build_packed(scene)
    ss = scene_stats(scene)
    assert ss["tris"] == scene.n_tris and ss["spheres"] == 2
    bs = bvh_stats(packed)
    assert bs["nodes"] == packed.n_nodes and bs["tables"] == 8


def test_queue_occupancy_drains():
    scene = cornell.cornell("empty")
    packed = build_packed(scene)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=2)
    occ = queue_occupancy(scene, cornell.camera(8, 8), cfg,
                          jax.random.key(0), packed, queue=64)
    assert occ["occupancy"][0] > 0            # queue fills
    assert occ["occupancy"][-1] == 0          # and drains by the bound
    assert 0 < occ["mean_occupancy"] <= 1.0


def test_render_report_roundtrip():
    cfg = RenderConfig(width=8, height=8, spp=1)
    rep = RenderReport(cfg=cfg)
    with rep.phase("build"):
        pass
    out = json.loads(rep.to_json(extra_field=1))
    assert out["config"]["width"] == 8
    assert "build" in out["timings"]
    assert out["extra_field"] == 1
