"""Finite-difference checks of the differentiable pass (BASELINE.json
config 4: grads w.r.t. vertex positions + albedo (+ emission/light radiance),
FD-checked).  SURVEY.md §4 item 4.

Scenes are chosen so the perturbation never moves a silhouette across a
sample (the detached-sampling estimator does not differentiate visibility
boundaries — see tpu_pt/diff/adjoint.py docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt.config import RenderConfig
from tpu_pt.core.camera import Camera
from tpu_pt.diff.adjoint import loss_and_grad, render_flat
from tpu_pt.diff.params import merge, split
from tpu_pt.scene.types import (
    LIGHT_AREA, MAT_DIFFUSE, MAT_GGX, make_lights, make_materials, make_scene,
)


def _plane_scene(mat_row=None):
    """A big diffuse quad at y=0 under an area light; camera above, looking
    down.  Every camera ray hits the quad for any small perturbation."""
    g = 4.0
    verts = [(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)]
    tris = [(0, 1, 2), (0, 2, 3)]
    mats = [0, 0]
    materials = make_materials([
        mat_row or dict(kind=MAT_DIFFUSE, albedo=(0.6, 0.4, 0.3)),
    ])
    lights = make_lights([
        dict(kind=LIGHT_AREA, position=(-0.5, 3.0, -0.5), edge_x=(1, 0, 0),
             edge_y=(0, 0, 1), normal=(0, -1, 0), radiance=(8.0, 8.0, 8.0)),
    ])
    return make_scene(np.asarray(verts, np.float32),
                      np.asarray(tris, np.int32),
                      np.asarray(mats, np.int32), materials, lights)


def _setup(spp=2, w=4, h=4, mat_row=None, **kw):
    scene = _plane_scene(mat_row)
    cam = Camera.look_at(eye=(0.0, 2.0, 0.01), target=(0, 0, 0), hfov=30,
                         aspect=1.0, up=(0, 0, -1))
    kw.setdefault("direct_only", True)
    cfg = RenderConfig(width=w, height=h, spp=spp, **kw)
    key = jax.random.key(0)
    return scene, cam, cfg, key


def _scalar(params, scene, cam, cfg, key, w_mat):
    img = render_flat(merge(params, scene), cam, cfg, key)
    return jnp.sum(img * w_mat)


def _fd_check(param_name, idx, eps, rtol, atol=1e-5, cfg_kw=None):
    scene, cam, cfg, key = _setup(**(cfg_kw or {}))
    params, _ = split(scene)
    w_mat = jax.random.uniform(jax.random.key(9), (cfg.n_pixels, 3))

    g = jax.grad(lambda p: _scalar(p, scene, cam, cfg, key, w_mat))(params)
    g_val = float(np.asarray(g[param_name])[idx])

    def eval_at(delta):
        p = dict(params)
        arr = np.asarray(params[param_name]).copy()
        arr[idx] += delta
        p[param_name] = jnp.asarray(arr)
        return float(_scalar(p, scene, cam, cfg, key, w_mat))

    fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
    assert np.isfinite(g_val)
    np.testing.assert_allclose(g_val, fd, rtol=rtol, atol=atol)


class TestFiniteDifference:
    def test_albedo_grad(self):
        _fd_check("albedo", (0, 0), eps=1e-2, rtol=2e-2)

    def test_light_radiance_grad(self):
        _fd_check("light_radiance", (0, 1), eps=1e-2, rtol=2e-2)

    def test_vertex_grad(self):
        # Move one quad vertex vertically: changes hit points, light
        # distances/cosines → radiance. Smooth (no silhouette crossing).
        _fd_check("vertices", (2, 1), eps=5e-3, rtol=8e-2, atol=5e-3)

    def test_emission_grad_on_emissive_cornell(self):
        # Cornell: emission of the light material is seen directly.
        from tpu_pt.scene import cornell

        scene = cornell.cornell("empty")
        cam = cornell.camera(8, 8)
        cfg = RenderConfig(width=8, height=8, spp=2, direct_only=True)
        key = jax.random.key(1)
        params, _ = split(scene)
        w_mat = jnp.ones((cfg.n_pixels, 3))

        g = jax.grad(
            lambda p: _scalar(p, scene, cam, cfg, key, w_mat)
        )(params)
        g_em = float(np.asarray(g["emission"])[3, 0])  # M_LIGHT red channel
        eps = 0.5

        def eval_at(delta):
            arr = np.asarray(params["emission"]).copy()
            arr[3, 0] += delta
            p = dict(params, emission=jnp.asarray(arr))
            return float(_scalar(p, scene, cam, cfg, key, w_mat))

        fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
        np.testing.assert_allclose(g_em, fd, rtol=2e-2)

    def test_roughness_grad(self):
        """FD-check d(pixel)/d(roughness) through the GGX NEE eval
        (BASELINE.json: gradients w.r.t. "BRDF albedo/roughness")."""
        ggx = dict(kind=MAT_GGX, albedo=(0.8, 0.6, 0.4), roughness=0.35)
        _fd_check("roughness", (0,), eps=1e-2, rtol=2e-2,
                  cfg_kw=dict(mat_row=ggx))

    def test_ggx_albedo_grad(self):
        ggx = dict(kind=MAT_GGX, albedo=(0.8, 0.6, 0.4), roughness=0.35)
        _fd_check("albedo", (0, 1), eps=1e-2, rtol=2e-2,
                  cfg_kw=dict(mat_row=ggx))

    def test_indirect_albedo_grad(self):
        # Full path tracing: albedo grads flow through multi-bounce beta.
        _fd_check("albedo", (0, 1), eps=1e-2, rtol=5e-2,
                  cfg_kw=dict(spp=2, direct_only=False, max_depth=2,
                              rr_start=5))


class TestProductionPathGrads:
    """BASELINE config 4 through the PRODUCTION path: wavefront scan +
    cluster intersector, 64² (VERDICT r1 missing #2)."""

    def _setup64(self):
        from tpu_pt.bvh.cluster import build_cluster_bvh

        scene, cam, cfg, key = _setup(spp=1, w=64, h=64)
        bvh = build_cluster_bvh(scene)
        params, _ = split(scene)
        target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
        return scene, cam, cfg, key, bvh, params, target

    def test_cluster_backend_fd_64(self):
        from tpu_pt.diff.adjoint import loss_and_grad_wavefront

        scene, cam, cfg, key, bvh, params, target = self._setup64()
        loss, grads = loss_and_grad_wavefront(
            params, scene, cam, cfg, key, target, bvh, queue=1024)
        g = float(np.asarray(grads["albedo"])[0, 0])

        def loss_at(d):
            arr = np.asarray(params["albedo"]).copy()
            arr[0, 0] += d
            p = dict(params, albedo=jnp.asarray(arr))
            l, _ = loss_and_grad_wavefront(
                p, scene, cam, cfg, key, target, bvh, queue=1024)
            return float(l)

        eps = 1e-2
        fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-7)
        assert np.isfinite(np.asarray(grads["vertices"])).all()

    def test_remat_chunking_matches_plain_scan(self):
        """Small queue (steps>16 → √steps-chunked remat scan) must give the
        same loss/grads as a big queue (plain scan) — queue invariance of
        the RNG extends to the adjoint sweep."""
        from tpu_pt.diff.adjoint import loss_and_grad_wavefront

        scene, cam, cfg, key, bvh, params, target = self._setup64()
        l_small, g_small = loss_and_grad_wavefront(
            params, scene, cam, cfg, key, target, bvh, queue=256)
        l_big, g_big = loss_and_grad_wavefront(
            params, scene, cam, cfg, key, target, bvh, queue=4096)
        np.testing.assert_allclose(float(l_small), float(l_big), rtol=1e-5)
        for k in g_small:
            np.testing.assert_allclose(np.asarray(g_small[k]),
                                       np.asarray(g_big[k]),
                                       rtol=1e-3, atol=1e-6)


class TestLossAndGrad:
    def test_inverse_rendering_step_descends(self):
        """One gradient step on albedo must reduce an L2 loss toward a
        target rendered with different albedo."""
        scene, cam, cfg, key = _setup(spp=2, w=6, h=6)
        params, _ = split(scene)
        target_params = dict(
            params, albedo=jnp.asarray([[0.3, 0.7, 0.5]], jnp.float32)
        )
        target = render_flat(merge(target_params, scene), cam, cfg, key)

        loss0, grads = loss_and_grad(params, scene, cam, cfg, key, target)
        stepped = dict(
            params, albedo=params["albedo"] - 2.0 * grads["albedo"]
        )
        loss1, _ = loss_and_grad(stepped, scene, cam, cfg, key, target)
        assert float(loss1) < float(loss0)
        # Non-optimized params also get finite grads.
        assert np.isfinite(np.asarray(grads["vertices"])).all()
        assert np.isfinite(np.asarray(grads["light_radiance"])).all()


def test_steps_hint_matches_full_bound():
    """A sufficient steps_hint must change nothing but the scan length:
    same loss, same grads (bit-for-bit), done=True; an absurdly small hint
    must report done=False (the caller's signal to redo full-bound)."""
    import numpy as np

    from tpu_pt.bvh.native import build_packed
    from tpu_pt.diff.adjoint import loss_and_grad_wavefront
    from tpu_pt.diff.params import split
    from tpu_pt.scene import cornell

    scene = cornell.cornell("spheres")
    pk = build_packed(scene)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3)
    cam = cornell.camera(16, 16)
    key = jax.random.key(2)
    params, _ = split(scene)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)

    loss0, g0 = loss_and_grad_wavefront(params, scene, cam, cfg, key,
                                        target, pk, backend="packed",
                                        queue=128)
    # Full bound for this config: n_steps = 16*16*2*4/128 + 4 = 20.
    loss1, g1, done = loss_and_grad_wavefront(params, scene, cam, cfg, key,
                                              target, pk, backend="packed",
                                              queue=128, steps_hint=18)
    assert bool(done)
    assert float(loss0) == float(loss1)
    for k in g0:
        np.testing.assert_array_equal(np.asarray(g0[k]), np.asarray(g1[k]))

    _, _, done_small = loss_and_grad_wavefront(params, scene, cam, cfg, key,
                                               target, pk, backend="packed",
                                               queue=128, steps_hint=3)
    assert not bool(done_small)
