"""Wavefront renderer equivalence: the persistent-queue renderer must match
the unrolled oracle integrator (same counter-based RNG → same radiance
samples), across queue sizes (respawn/packing invariance).  SURVEY.md §4."""

import jax
import numpy as np
import pytest

from tpu_pt.bvh.sah import build_bvh
from tpu_pt.config import RenderConfig
from tpu_pt.render.driver import render
from tpu_pt.render.wavefront import n_steps, render_wavefront
from tpu_pt.scene import cornell


@pytest.fixture(scope="module")
def setup():
    scene = cornell.cornell("spheres")
    bvh = build_bvh(scene)
    return scene, bvh


def _cfg(**kw):
    kw.setdefault("width", 16)
    kw.setdefault("height", 16)
    kw.setdefault("spp", 4)
    kw.setdefault("max_depth", 2)
    return RenderConfig(**kw)


class TestWavefrontEquivalence:
    def test_direct_only_matches_oracle(self, setup):
        scene, bvh = setup
        cfg = _cfg(direct_only=True)
        key = jax.random.key(0)
        cam = cornell.camera(cfg.width, cfg.height)
        ref = render(scene, cam, cfg, key, backend="brute")
        img = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                          queue=256, backend="brute"))
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)

    def test_full_pt_matches_oracle(self, setup):
        scene, bvh = setup
        cfg = _cfg(rr_start=1, rr_prob=0.8)
        key = jax.random.key(3)
        cam = cornell.camera(cfg.width, cfg.height)
        ref = render(scene, cam, cfg, key, backend="brute")
        img = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                          queue=256, backend="brute"))
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)

    def test_queue_size_invariance(self, setup):
        """Respawn scheduling must not change the image (order-invariant
        RNG): tiny queue (many refills) == huge queue (one spawn wave)."""
        scene, bvh = setup
        cfg = _cfg()
        key = jax.random.key(1)
        cam = cornell.camera(cfg.width, cfg.height)
        small = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                            queue=64, backend="bvh"))
        large = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                            queue=4096, backend="bvh"))
        np.testing.assert_allclose(small, large, rtol=1e-4, atol=1e-6)

    def test_glossy_matches_oracle(self):
        """GGX materials must keep the wavefront == oracle equivalence
        (same bsdf module on both paths)."""
        scene = cornell.cornell("glossy")
        bvh = build_bvh(scene)
        cfg = _cfg(rr_start=1, rr_prob=0.8)
        key = jax.random.key(5)
        cam = cornell.camera(cfg.width, cfg.height)
        ref = render(scene, cam, cfg, key, backend="brute")
        img = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                          queue=256, backend="brute"))
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)

    def test_bvh_backend_matches_brute_backend(self, setup):
        scene, bvh = setup
        cfg = _cfg()
        key = jax.random.key(2)
        cam = cornell.camera(cfg.width, cfg.height)
        a = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                        queue=512, backend="bvh"))
        b = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                        queue=512, backend="brute"))
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


class TestStepBound:
    def test_n_steps_bound(self):
        cfg = _cfg(spp=8)
        assert n_steps(cfg, 256) >= (16 * 16 * 8 * 3) // 256
        cfg_d = _cfg(direct_only=True)
        assert n_steps(cfg_d, 1 << 20) == 2  # one wave + drain

    def test_energy_conserved_tail(self, setup):
        """Samples spawned in the drain tail must still complete: render with
        a queue that does not divide the sample count."""
        scene, bvh = setup
        cfg = _cfg(width=10, height=10, spp=3)
        cam = cornell.camera(10, 10)
        key = jax.random.key(5)
        img_a = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                            queue=77, backend="bvh"))
        img_b = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                            queue=300, backend="bvh"))
        np.testing.assert_allclose(img_a, img_b, rtol=1e-4, atol=1e-6)

    def test_spp1_unique_scatter_matches_oracle(self, setup=None):
        """spp=1 takes the unique_indices accumulator scatter (r5): every
        in-flight lane owns a distinct pixel, so the cheap non-combining
        scatter lowering is exact — must match the oracle bit-for-bit and
        be queue-invariant."""
        scene = cornell.cornell("spheres")
        bvh = build_bvh(scene)
        cfg = _cfg(spp=1, rr_start=1, rr_prob=0.8)
        key = jax.random.key(7)
        cam = cornell.camera(cfg.width, cfg.height)
        ref = render(scene, cam, cfg, key, backend="brute")
        img = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                          queue=64, backend="brute"))
        np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)
        img2 = np.asarray(render_wavefront(scene, cam, cfg, key, bvh,
                                           queue=512, backend="bvh"))
        np.testing.assert_allclose(img2, ref, rtol=1e-4, atol=1e-5)

    def test_step_slices_match(self):
        """Whole-step lane slicing (r5): per-lane math is unchanged, so at
        spp=1 (unique-pixel scatter) the sliced step must reproduce the
        unsliced render bit-for-bit."""
        from tpu_pt.render.wavefront import wavefront_accum

        scene = jax.device_put(cornell.cornell("spheres"))
        bvh = jax.device_put(build_bvh(cornell.cornell("spheres")))
        cfg = _cfg(width=64, height=64, spp=1, rr_start=1, rr_prob=0.8)
        cam = cornell.camera(64, 64)
        key = jax.random.key(11)
        a = np.asarray(wavefront_accum(scene, cam, cfg, key, bvh,
                                       4096, "bvh", 0, cfg.n_pixels,
                                       fast=True))
        b = np.asarray(wavefront_accum(scene, cam, cfg, key, bvh,
                                       4096, "bvh", 0, cfg.n_pixels,
                                       fast=True, step_slices=2))
        np.testing.assert_array_equal(a, b)


def test_render_wavefront_checked_passes_and_catches_poison():
    """debug_checks render: clean scene passes every invariant; a
    NaN-poisoned vertex trips the checkify error."""
    import jax.numpy as jnp
    from jax.experimental import checkify

    from tpu_pt.bvh.native import build_packed
    from tpu_pt.render.wavefront import render_wavefront_checked

    scene = cornell.cornell("spheres")
    pk = build_packed(scene)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    cam = cornell.camera(16, 16)
    key = jax.random.key(0)
    img = render_wavefront_checked(scene, cam, cfg, key, pk, queue=256,
                                   backend="packed")
    ref = render_wavefront(scene, cam, cfg, key, pk, queue=256,
                           backend="packed", fast=False)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))

    bad = scene._replace(
        vertices=jnp.asarray(scene.vertices).at[0].set(jnp.nan))
    with pytest.raises(checkify.JaxRuntimeError):
        render_wavefront_checked(bad, cam, cfg, key, pk, queue=256,
                                 backend="packed")
