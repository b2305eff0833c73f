"""Nearest-hit tie-break: at equal t, every backend returns the LOWEST
primitive gid (SURVEY.md §4 item 2; the brute oracle's argmin-first rule).
Coincident geometry makes ties deterministic, so these are exact gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt.render import brute
from tpu_pt.scene.types import (MAT_DIFFUSE, make_lights, make_materials,
                                make_scene)


def _coincident_scene(n_copies=3):
    """n_copies identical quads stacked exactly (z=0), plus an offset quad
    behind them — every camera ray hits all copies at the same t."""
    verts, tris = [], []
    for c in range(n_copies):
        base = len(verts)
        verts += [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
        tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    base = len(verts)
    verts += [(-2, -2, -1), (2, -2, -1), (2, 2, -1), (-2, 2, -1)]
    tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return make_scene(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        np.zeros(len(tris), np.int32),
        make_materials([dict(kind=MAT_DIFFUSE)]),
        make_lights([]))


def _rays(n=64, seed=0):
    k1, k2 = jax.random.split(jax.random.key(seed))
    # Origins in front of the stack, shooting straight at it with jitter.
    ro = jnp.stack([jax.random.uniform(k1, (n,), minval=-0.9, maxval=0.9),
                    jax.random.uniform(k2, (n,), minval=-0.9, maxval=0.9),
                    jnp.full((n,), 3.0)], axis=1)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    return ro, rd


@pytest.fixture(scope="module")
def setup():
    scene = _coincident_scene()
    ro, rd = _rays()
    t_min = jnp.zeros((ro.shape[0], 1))
    t_max = jnp.full((ro.shape[0], 1), 1e30)
    ref = brute.intersect(scene, ro, rd, t_min, t_max)
    # Sanity: every ray hits, and the winner is one of tris 0/1 (first copy).
    assert bool(np.asarray(ref.hit).all())
    assert set(np.asarray(ref.prim).tolist()) <= {0, 1}
    return scene, ro, rd, t_min, t_max, ref


def _check(ref, got):
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(got.hit))
    np.testing.assert_array_equal(np.asarray(ref.prim), np.asarray(got.prim))
    np.testing.assert_array_equal(np.asarray(ref.t), np.asarray(got.t))


def test_flat_bvh_tiebreak(setup):
    from tpu_pt.bvh import flat
    from tpu_pt.bvh.sah import build_bvh

    scene, ro, rd, t_min, t_max, ref = setup
    _check(ref, flat.intersect(build_bvh(scene), scene, ro, rd, t_min, t_max))


def test_packed_tiebreak(setup):
    from tpu_pt.bvh import packed
    from tpu_pt.bvh.native import build_packed

    scene, ro, rd, t_min, t_max, ref = setup
    pk = build_packed(scene)
    _check(ref, packed.intersect(pk, scene, ro, rd, t_min, t_max))


@pytest.mark.parametrize("mode", ["compact", "frontier", "pairs"])
def test_cluster_tiebreak(setup, mode):
    from tpu_pt.bvh import cluster as cl

    scene, ro, rd, t_min, t_max, ref = setup
    cb = cl.build_cluster_bvh(scene)
    old = cl.TRAVERSAL_MODE
    cl.TRAVERSAL_MODE = mode
    try:
        got = cl.intersect(cb, scene, ro, rd, t_min, t_max)
    finally:
        cl.TRAVERSAL_MODE = old
    _check(ref, got)


def test_cluster_lanes_gid_sorted(setup):
    """Build invariant behind the pair test's first-lane argmin rule: tile
    lanes are gid-ascending (real lanes)."""
    from tpu_pt.bvh import cluster as cl

    scene, *_ = setup
    cb = cl.build_cluster_bvh(scene)
    gid = np.asarray(cb.tile_gid)
    real = (np.abs(np.asarray(cb.tiles)).sum(axis=1) > 0)
    for c in range(gid.shape[0]):
        g = gid[c][real[c]]
        assert (np.diff(g) > 0).all()


def test_sphere_tri_tie_prefers_triangle():
    """A sphere touching a triangle at the hit point: triangle gid < sphere
    gid, so the triangle must win (brute's <= rule)."""
    verts = [(-1, -1, 0), (1, -1, 0), (0, 1, 0)]
    scene = make_scene(
        np.asarray(verts, np.float32), np.asarray([(0, 1, 2)], np.int32),
        np.zeros(1, np.int32),
        make_materials([dict(kind=MAT_DIFFUSE)]),
        make_lights([]),
        sph_center=np.asarray([[0.0, 0.0, -1.0]], np.float32),
        sph_radius=np.asarray([1.0], np.float32),
        sph_mat=np.zeros(1, np.int32))
    ro = jnp.asarray([[0.0, 0.0, 3.0]])
    rd = jnp.asarray([[0.0, 0.0, -1.0]])
    t_min = jnp.zeros((1, 1))
    t_max = jnp.full((1, 1), 1e30)
    ref = brute.intersect(scene, ro, rd, t_min, t_max)
    assert int(np.asarray(ref.prim)[0]) == 0  # triangle, not sphere (gid 1)

    from tpu_pt.bvh import cluster as cl

    got = cl.intersect(cl.build_cluster_bvh(scene), scene, ro, rd,
                       t_min, t_max)
    np.testing.assert_array_equal(np.asarray(ref.prim), np.asarray(got.prim))
