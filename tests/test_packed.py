"""Packed (octant-ordered, gather-minimal) traversal equivalence tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt.bvh import packed as pk
from tpu_pt.bvh.sah import build_bvh
from tpu_pt.render import brute
from tpu_pt.scene import cornell, meshes
from tpu_pt.scene.types import make_lights, make_materials, make_scene


@pytest.fixture(scope="module")
def setups():
    out = {}
    s1 = cornell.cornell("spheres")
    out["cornell"] = (s1, pk.pack_bvh(build_bvh(s1), s1))
    v, f = meshes.icosphere(subdiv=2)
    s2 = make_scene(v, f, np.zeros(len(f), np.int32),
                    make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                    make_lights([]))
    out["mesh"] = (s2, pk.pack_bvh(build_bvh(s2), s2))
    return out


def _rays(n, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    ro = jax.random.uniform(k1, (n, 3), minval=-3, maxval=3).astype(jnp.float32)
    rd = jax.random.normal(k2, (n, 3))
    return ro, (rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)).astype(jnp.float32)


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_intersect_matches_brute(setups, name):
    scene, packed = setups[name]
    ro, rd = _rays(1024, 7)
    tmin = jnp.zeros((1024, 1))
    tmax = jnp.full((1024, 1), 1e30)
    h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
    h_pk = pk.intersect(packed, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_ref.hit), np.asarray(h_pk.hit))
    m = np.asarray(h_ref.hit)[:, 0]
    np.testing.assert_allclose(
        np.asarray(h_ref.t)[m], np.asarray(h_pk.t)[m], rtol=1e-5, atol=1e-6
    )
    assert (np.asarray(h_ref.prim) == np.asarray(h_pk.prim))[m].mean() > 0.99


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_occluded_matches_brute(setups, name):
    scene, packed = setups[name]
    ro, rd = _rays(1024, 8)
    tmax = jnp.full((1024, 1), 2.0)
    o_ref = brute.occluded(scene, ro, rd, tmax)
    o_pk = pk.occluded(packed, scene, ro, rd, tmax)
    np.testing.assert_array_equal(np.asarray(o_ref), np.asarray(o_pk))


def test_octant_tables_reference_same_tree(setups):
    """All 8 octant tables must describe the same tree: same multiset of
    leaf (start,count) pairs and same root box."""
    _, packed = setups["cornell"]
    nodes = packed.node_rows()
    metas = nodes[..., 7].view(np.int32)
    for o in range(1, 8):
        np.testing.assert_allclose(nodes[o, 0, 0:6], nodes[0, 0, 0:6])
        a = np.sort(metas[0][metas[0] >= 0])
        b = np.sort(metas[o][metas[o] >= 0])
        np.testing.assert_array_equal(a, b)


def test_render_packed_matches_oracle(setups):
    from tpu_pt.config import RenderConfig
    from tpu_pt.render.driver import render

    scene, packed = setups["cornell"]
    cam = cornell.camera(24, 24)
    cfg = RenderConfig(width=24, height=24, spp=4, max_depth=3)
    key = jax.random.key(2)
    ref = render(scene, cam, cfg, key, backend="brute")
    img = render(scene, cam, cfg, key, backend="packed", bvh=packed)
    np.testing.assert_allclose(img, ref, rtol=1e-3, atol=1e-3)


def test_wavefront_packed_matches_oracle(setups):
    from tpu_pt.config import RenderConfig
    from tpu_pt.render.driver import render
    from tpu_pt.render.wavefront import render_wavefront

    scene, packed = setups["cornell"]
    cam = cornell.camera(16, 16)
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=2)
    key = jax.random.key(3)
    ref = render(scene, cam, cfg, key, backend="brute")
    img = np.asarray(render_wavefront(scene, cam, cfg, key, packed,
                                      queue=512, backend="packed"))
    np.testing.assert_allclose(img, ref, rtol=1e-3, atol=1e-3)


def test_native_builder_matches_python(setups):
    """Native C++ builder must produce traversal-equivalent tables."""
    from tpu_pt.bvh import native

    scene, packed_py = setups["mesh"]
    packed_nat = native.build_packed(scene)
    assert packed_nat.n_nodes == packed_py.n_nodes
    ro, rd = _rays(512, 21)
    tmin = jnp.zeros((512, 1))
    tmax = jnp.full((512, 1), 1e30)
    h_a = pk.intersect(packed_py, scene, ro, rd, tmin, tmax)
    h_b = pk.intersect(packed_nat, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_a.hit), np.asarray(h_b.hit))
    m = np.asarray(h_a.hit)[:, 0]
    np.testing.assert_allclose(
        np.asarray(h_a.t)[m], np.asarray(h_b.t)[m], rtol=1e-5, atol=1e-6
    )
