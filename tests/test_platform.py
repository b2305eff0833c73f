"""Host-side contracts of running on a GPU: the compile cache location, the
GPU smoke check's refusal to run without a GPU, full-precision camera rays,
and the native BVH builder compiled from source."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt.core.camera import Camera, generate_rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_update, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env_update)
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(from_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache."""
    code = ("import jax; from tpu_pt.cli import enable_compile_cache; "
            "print(enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    want = str(tmp_path / "cache") if from_env else os.path.join(
        ROOT, ".jax_cache")
    if from_env:
        res = _run(["-c", code], {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        res = _run(["-c", code], {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [want, want]
    assert os.path.isdir(want)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke check exits non-zero and reports no result."""
    res = _run(["chip_smoke.py"], {})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_generate_rays_matches_float64():
    """Ray directions at full f32 precision (no reduced-precision matmul):
    within 1e-6 of a float64 numpy pinhole model."""
    rng = np.random.default_rng(4)
    cam = Camera.look_at(eye=(0.3, 1.7, 4.2), target=(-0.5, 0.9, -1.0),
                         hfov=47.0, aspect=1.6)
    xy = rng.random((4096, 2), dtype=np.float32)
    ro, rd = generate_rays(cam, jnp.asarray(xy))

    c2w = np.asarray(cam.c2w, np.float64)
    tan_h = np.tan(np.radians(float(cam.hfov)) / 2)
    tan_v = np.tan(np.radians(float(cam.vfov)) / 2)
    x = xy.astype(np.float64)
    d = np.stack([(2 * x[:, 0] - 1) * tan_h, (2 * x[:, 1] - 1) * tan_v,
                  -np.ones(len(x))], -1) @ c2w.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(rd), d, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(ro), np.broadcast_to(np.asarray(cam.origin), (4096, 3)))


def test_native_builds_from_source_and_matches_python(tmp_path,
                                                      monkeypatch):
    """The native builder compiles from native/bvh_builder.cpp into the
    build directory (which git ignores) and agrees with the Python SAH +
    octant pack on node count and nearest hits."""
    from tpu_pt.bvh import native
    from tpu_pt.bvh import packed as pk
    from tpu_pt.bvh.sah import build_bvh
    from tpu_pt.scene import meshes
    from tpu_pt.scene.types import make_lights, make_materials, make_scene

    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert native.BUILD_DIR == os.path.join(ROOT, "build")

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    path = native.build()
    assert os.path.dirname(path) == str(tmp_path) and os.path.isfile(path)
    assert native.build() == path  # built once per source version

    v, f = meshes.icosphere(subdiv=3)
    scene = make_scene(v, f, np.zeros(len(f), np.int32),
                       make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                       make_lights([]))
    nat = native.build_packed(scene)
    py = pk.pack_bvh(build_bvh(scene), scene)
    assert nat.n_nodes == py.n_nodes
    k1, k2 = jax.random.split(jax.random.key(21))
    ro = jax.random.normal(k1, (512, 3))
    ro = 3.0 * ro / jnp.linalg.norm(ro, axis=-1, keepdims=True)
    rd = 0.3 * jax.random.normal(k2, (512, 3)) - ro / 3.0  # roughly inward
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    tmin, tmax = jnp.zeros((512, 1)), jnp.full((512, 1), 1e30)
    h_a = pk.intersect(py, scene, ro, rd, tmin, tmax)
    h_b = pk.intersect(nat, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_a.hit), np.asarray(h_b.hit))
    m = np.asarray(h_a.hit)[:, 0]
    assert m.sum() > 256
    np.testing.assert_allclose(np.asarray(h_a.t)[m], np.asarray(h_b.t)[m],
                               rtol=1e-5, atol=1e-6)
