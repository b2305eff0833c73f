"""Progressive/checkpointed rendering: chunked == one-shot; resume works.
SURVEY.md §5 'Checkpoint / resume'."""

import os

import jax
import numpy as np
import pytest

from tpu_pt.bvh.native import build_packed
from tpu_pt.config import RenderConfig
from tpu_pt.render.progressive import render_progressive
from tpu_pt.render.wavefront import render_wavefront
from tpu_pt.scene import cornell


@pytest.fixture(scope="module")
def setup():
    scene = cornell.cornell("spheres")
    return scene, build_packed(scene)


def test_chunked_equals_oneshot(setup):
    scene, packed = setup
    cfg = RenderConfig(width=12, height=12, spp=6, max_depth=2)
    cam = cornell.camera(12, 12)
    key = jax.random.key(0)
    oneshot = np.asarray(render_wavefront(scene, cam, cfg, key, packed,
                                          queue=256, backend="packed"))
    chunked = render_progressive(scene, cam, cfg, key, packed,
                                 chunk_spp=2, queue=256, backend="packed")
    np.testing.assert_allclose(chunked, oneshot, rtol=1e-5, atol=1e-7)


def test_resume_from_checkpoint(setup, tmp_path):
    scene, packed = setup
    cfg = RenderConfig(width=10, height=10, spp=4, max_depth=1)
    cam = cornell.camera(10, 10)
    key = jax.random.key(1)
    ckpt = str(tmp_path / "render.npz")

    # Render only half by interrupting via on_chunk exception.
    class Stop(Exception):
        pass

    def stop_after_half(spp_done, img):
        if spp_done >= 2:
            raise Stop()

    with pytest.raises(Stop):
        render_progressive(scene, cam, cfg, key, packed, checkpoint=ckpt,
                           chunk_spp=2, queue=256, on_chunk=stop_after_half)
    assert os.path.exists(ckpt)
    data = np.load(ckpt)
    assert int(data["spp_done"]) == 2

    # Resume completes and matches the uninterrupted render.
    resumed = render_progressive(scene, cam, cfg, key, packed,
                                 checkpoint=ckpt, chunk_spp=2, queue=256)
    full = render_progressive(scene, cam, cfg, key, packed,
                              chunk_spp=2, queue=256)
    np.testing.assert_allclose(resumed, full, rtol=1e-6, atol=1e-8)


def test_checkpoint_invalidated_by_config_change(setup, tmp_path):
    scene, packed = setup
    cam = cornell.camera(10, 10)
    key = jax.random.key(2)
    ckpt = str(tmp_path / "render.npz")
    cfg1 = RenderConfig(width=10, height=10, spp=2, max_depth=1)
    render_progressive(scene, cam, cfg1, key, packed, checkpoint=ckpt,
                       chunk_spp=2, queue=256)
    # Different config: stale checkpoint must be ignored, not resumed.
    cfg2 = RenderConfig(width=10, height=10, spp=2, max_depth=2)
    img2 = render_progressive(scene, cam, cfg2, key, packed, checkpoint=ckpt,
                              chunk_spp=2, queue=256)
    ref2 = render_progressive(scene, cam, cfg2, key, packed,
                              chunk_spp=2, queue=256)
    np.testing.assert_allclose(img2, ref2, rtol=1e-6, atol=1e-8)


def test_fallback_retry_resumes_clean_checkpoint(tmp_path):
    """Verify-then-retry for progressive renders (VERDICT r5 task 6): a
    cluster render whose caps overflow mid-job aborts (stop_on_overflow)
    without tainting the checkpoint, and the fallback-attached retry
    RESUMES the clean chunks — the final image must be bit-identical to a
    one-shot fallback-attached render, and the resumed run must only
    render the remaining chunks."""
    from tpu_pt.bvh import cluster as cl
    from tpu_pt.scene import meshes
    from tpu_pt.scene.types import (LIGHT_POINT, make_lights, make_materials,
                                    make_scene)

    v, f = meshes.icosphere(subdiv=3)
    scene = make_scene(v, f, np.zeros(len(f), np.int32),
                       make_materials([dict(albedo=(0.6, 0.6, 0.6),
                                            emission=(1.0, 1.0, 1.0))]),
                       make_lights([dict(kind=LIGHT_POINT,
                                         position=(0, 2, 0),
                                         radiance=(5.0, 5.0, 5.0))]))
    cam = cornell.camera(10, 10)
    cfg = RenderConfig(width=10, height=10, spp=4, max_depth=1)
    key = jax.random.key(3)
    n_lv = len(cl.build_cluster_bvh(scene, tile=32).levels)
    cb_bad = cl.build_cluster_bvh(scene, tile=32, frontiers=(2,) * n_lv,
                                  k_leaf=2, pair_mults=(1, 1, 1))
    ckpt = str(tmp_path / "r.npz")

    # Overflowing run aborts early; nothing inexact is checkpointed.
    img, novf = render_progressive(scene, cam, cfg, key, cb_bad,
                                   checkpoint=ckpt, chunk_spp=2, queue=128,
                                   backend="cluster", return_counts=True,
                                   stop_on_overflow=True)
    assert novf > 0
    if os.path.exists(ckpt):
        assert bool(np.load(ckpt)["exact"])

    # Retry with the exact fallback attached resumes (or restarts) and
    # completes; must equal the one-shot fallback-attached render.
    cb_exact = cl.attach_fallback(cb_bad, scene)
    chunks = []
    img2, novf2 = render_progressive(
        scene, cam, cfg, key, cb_exact, checkpoint=ckpt, chunk_spp=2,
        queue=128, backend="cluster", return_counts=True,
        stop_on_overflow=True, overflow_is_exact=True,
        on_chunk=lambda s, i: chunks.append(s))
    # Bit-exact vs the same-chunking fallback-attached render (chunk sums
    # associate identically); ULP-close vs the one-shot render (host-side
    # chunk addition reassociates float adds).
    ref_chunked = render_progressive(scene, cam, cfg, key, cb_exact,
                                     chunk_spp=2, queue=128,
                                     backend="cluster")
    np.testing.assert_array_equal(np.asarray(img2), np.asarray(ref_chunked))
    ref = np.asarray(render_wavefront(scene, cam, cfg, key, cb_exact,
                                      queue=128, backend="cluster"))
    np.testing.assert_allclose(np.asarray(img2), ref, rtol=1e-6, atol=1e-7)
    # The retry rendered only the chunks the aborted run had not finished.
    assert len(chunks) <= 2
