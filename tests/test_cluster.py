"""Cluster-BVH (two-phase intersector) equivalence tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt.bvh import cluster as cl
from tpu_pt.render import brute
from tpu_pt.scene import cornell, meshes
from tpu_pt.scene.types import make_lights, make_materials, make_scene


@pytest.fixture(scope="module")
def setups():
    out = {}
    s1 = cornell.cornell("spheres")
    out["cornell"] = (s1, cl.build_cluster_bvh(s1))
    v, f = meshes.icosphere(subdiv=3)
    s2 = make_scene(v, f, np.zeros(len(f), np.int32),
                    make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                    make_lights([]))
    # tile=32 forces a real multi-level pyramid on a small mesh.
    out["mesh"] = (s2, cl.build_cluster_bvh(s2, tile=32))
    s3 = meshes.big_scene(subdiv=4)  # ~5k tris
    out["big"] = (s3, cl.build_cluster_bvh(s3, tile=64))
    return out


def _rays(n, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    ro = jax.random.uniform(k1, (n, 3), minval=-3, maxval=3).astype(jnp.float32)
    rd = jax.random.normal(k2, (n, 3))
    return ro, (rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)).astype(jnp.float32)


def test_build_invariants(setups):
    scene, cb = setups["big"]
    # Every primitive appears exactly once across tile_gid's real lanes.
    gid = np.asarray(cb.tile_gid)
    tiles = np.asarray(cb.tiles)
    real = (np.abs(tiles).sum(axis=1) > 0).reshape(-1)  # non-zero lanes
    ids = gid.reshape(-1)[real]
    assert sorted(ids.tolist()) == list(range(scene.n_prims))
    # Pyramid: parent AABBs contain children; sizes are exact 8x ladders.
    for l in range(len(cb.levels) - 1):
        parent = np.asarray(cb.levels[l])
        child = np.asarray(cb.levels[l + 1])
        assert child.shape[0] == 8 * parent.shape[0]
        c_lo = child[:, 0:3].reshape(-1, 8, 3)
        c_hi = child[:, 3:6].reshape(-1, 8, 3)
        finite = (c_lo <= c_hi).all(-1)
        for p in range(parent.shape[0]):
            if finite[p].any():
                assert (parent[p, 0:3] <= c_lo[p][finite[p]] + 1e-6).all()
                assert (parent[p, 3:6] >= c_hi[p][finite[p]] - 1e-6).all()


@pytest.mark.parametrize("name", ["cornell", "mesh", "big"])
def test_intersect_matches_brute(setups, name):
    scene, cb = setups[name]
    ro, rd = _rays(1024, 7)
    tmin = jnp.zeros((1024, 1))
    tmax = jnp.full((1024, 1), 1e30)
    h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
    h_cl = cl.intersect(cb, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_ref.hit), np.asarray(h_cl.hit))
    m = np.asarray(h_ref.hit)[:, 0]
    np.testing.assert_allclose(
        np.asarray(h_ref.t)[m], np.asarray(h_cl.t)[m], rtol=1e-5, atol=1e-6
    )
    # Exact agreement (r3): the lowest-gid tie rule makes prim ids equal
    # wherever both backends computed the same nearest t bitwise; rays
    # where the two float paths round t differently (ULP) may legitimately
    # pick different coincident prims — require those to be rare.
    t_same = (np.asarray(h_ref.t)[:, 0] == np.asarray(h_cl.t)[:, 0])[m]
    prim_eq = (np.asarray(h_ref.prim) == np.asarray(h_cl.prim))[m]
    np.testing.assert_array_equal(prim_eq[t_same], True)
    assert prim_eq.mean() > 0.999


@pytest.mark.parametrize("name", ["cornell", "mesh", "big"])
def test_occluded_matches_brute(setups, name):
    scene, cb = setups[name]
    ro, rd = _rays(1024, 8)
    tmax = jnp.full((1024, 1), 2.0)
    o_ref = brute.occluded(scene, ro, rd, tmax)
    o_cl = cl.occluded(cb, scene, ro, rd, tmax)
    np.testing.assert_array_equal(np.asarray(o_ref), np.asarray(o_cl))


@pytest.mark.parametrize("name", ["cornell", "mesh", "big"])
def test_no_truncation_on_test_scenes(setups, name):
    """The capacity contract: default frontiers/K lose nothing here."""
    _, cb = setups[name]
    ro, rd = _rays(2048, 9)
    n_cand, overflow = cl.candidate_stats(
        cb, ro, rd, jnp.zeros((2048,)), jnp.full((2048,), 1e30))
    assert int(np.asarray(overflow).sum()) == 0
    # Pair budget holds on average (the compaction cap is Q*pair_budget).
    assert float(np.asarray(n_cand).mean()) <= cb.pair_budget


def test_render_cluster_matches_oracle(setups):
    from tpu_pt.config import RenderConfig
    from tpu_pt.render.driver import render
    from tpu_pt.render.wavefront import render_wavefront

    scene, cb = setups["cornell"]
    cam = cornell.camera(24, 24)
    cfg = RenderConfig(width=24, height=24, spp=4, max_depth=3)
    key = jax.random.key(3)
    img_ref = render(scene, cam, cfg, key, backend="brute")
    img_cl = np.asarray(
        render_wavefront(scene, cam, cfg, key, cb, queue=512,
                         backend="cluster"))
    np.testing.assert_allclose(img_cl, img_ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["cornell", "big"])
def test_device_build_matches_brute(setups, name):
    """The jit-able Morton-chunk device build is traversal-correct."""
    scene, _ = setups[name]
    cb = jax.jit(cl.build_cluster_device, static_argnames=("tile",))(
        scene, tile=64)
    ro, rd = _rays(512, 11)
    tmin = jnp.zeros((512, 1))
    tmax = jnp.full((512, 1), 1e30)
    h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
    h_cl = cl.intersect(cb, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_ref.hit), np.asarray(h_cl.hit))
    m = np.asarray(h_ref.hit)[:, 0]
    np.testing.assert_allclose(
        np.asarray(h_ref.t)[m], np.asarray(h_cl.t)[m], rtol=1e-5, atol=1e-6)


def test_device_build_pyramid_invariants(setups):
    scene, _ = setups["big"]
    cb = cl.build_cluster_device(scene, tile=64)
    gid = np.asarray(cb.tile_gid)
    tiles = np.asarray(cb.tiles)
    real = (np.abs(tiles).sum(axis=1) > 0).reshape(-1)
    ids = gid.reshape(-1)[real]
    assert sorted(ids.tolist()) == list(range(scene.n_prims))
    for l in range(len(cb.levels) - 1):
        parent = np.asarray(cb.levels[l])
        child = np.asarray(cb.levels[l + 1])
        assert child.shape[0] == 8 * parent.shape[0]


def test_autotune_frontiers(setups):
    """Autotuned caps cover measured needs and stay traversal-correct."""
    scene, _ = setups["big"]
    ro, rd = _rays(1024, 17)
    cb = cl.autotune_frontiers(scene, ro, rd, tile=64)
    counts = np.asarray(cl.level_hit_counts(cb, ro, rd))
    for l in range(len(cb.levels)):
        assert cb.frontiers[l] >= counts[:, l].max()
    tmin = jnp.zeros((1024, 1))
    tmax = jnp.full((1024, 1), 1e30)
    h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
    h_cl = cl.intersect(cb, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_ref.hit), np.asarray(h_cl.hit))


@pytest.mark.parametrize("name", ["cornell", "mesh", "big"])
def test_pairs_mode_matches_frontier(setups, name, monkeypatch):
    """The pair-major traversal (r2 optimization target) must report the
    identical hits and occlusion as the frontier walk on every scene."""
    scene, cb = setups[name]
    ro, rd = _rays(512, 17)
    t_min = jnp.zeros((512, 1), jnp.float32)
    t_max = jnp.full((512, 1), 1e30, jnp.float32)

    monkeypatch.setattr(cl, "TRAVERSAL_MODE", "frontier")
    h_f = cl.intersect(cb, scene, ro, rd, t_min, t_max)
    o_f = cl.occluded(cb, scene, ro, rd, jnp.full((512, 1), 2.0))
    monkeypatch.setattr(cl, "TRAVERSAL_MODE", "pairs")
    h_p = cl.intersect(cb, scene, ro, rd, t_min, t_max)
    o_p = cl.occluded(cb, scene, ro, rd, jnp.full((512, 1), 2.0))

    np.testing.assert_array_equal(np.asarray(h_f.hit), np.asarray(h_p.hit))
    np.testing.assert_allclose(np.asarray(h_f.t), np.asarray(h_p.t),
                               rtol=1e-6)
    hit = np.asarray(h_f.hit)[:, 0]
    np.testing.assert_array_equal(np.asarray(h_f.prim)[hit],
                                  np.asarray(h_p.prim)[hit])
    np.testing.assert_array_equal(np.asarray(o_f), np.asarray(o_p))


def test_overflow_surfaced_out_of_contract(setups):
    """Capacity contract enforcement (VERDICT r2 task 4): a cluster build
    whose static caps are too small for the scene must REPORT truncation
    through the production render path — never silently drop hits — and
    the default build must report exactly zero on the same render."""
    from tpu_pt.config import RenderConfig
    from tpu_pt.render.wavefront import render_wavefront_counts

    scene, cb_good = setups["mesh"]
    cam = cornell.camera(16, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    key = jax.random.key(5)

    _, _, _, novf_good, _ = render_wavefront_counts(
        scene, cam, cfg, key, cb_good, queue=256, backend="cluster")
    assert int(np.asarray(novf_good)) == 0

    # Adversarially tiny frontier caps + leaf budget: guaranteed overflow.
    n_lv = len(cb_good.levels)
    cb_bad = cl.build_cluster_bvh(scene, frontiers=(1,) * n_lv, k_leaf=1,
                                  pair_mults=(1, 1, 1))
    _, _, _, novf_bad, _ = render_wavefront_counts(
        scene, cam, cfg, key, cb_bad, queue=256, backend="cluster")
    assert int(np.asarray(novf_bad)) > 0


def test_intersect_counted_zero_on_contract(setups):
    scene, cb = setups["cornell"]
    ro, rd = _rays(256, 11)
    hit, ovf = cl.intersect_counted(cb, scene, ro, rd,
                                    jnp.zeros((256, 1)),
                                    jnp.full((256, 1), 1e30))
    assert int(np.asarray(ovf)) == 0
    h2 = cl.intersect(cb, scene, ro, rd, jnp.zeros((256, 1)),
                      jnp.full((256, 1), 1e30))
    np.testing.assert_array_equal(np.asarray(hit.prim), np.asarray(h2.prim))


def test_split_traversal_bit_identical(setups, monkeypatch):
    """Intra-batch traversal splitting (r5: measured sub-linear batch-width
    cost, tools/profile_split.py) must be bit-identical per ray to the
    unsplit traversal — every stage reduces per ray, so the only possible
    divergence is the per-sub-batch pair-budget slicing, which the test
    scenes never hit (overflow == 0 asserted)."""
    scene, cb = setups["big"]
    ro, rd = _rays(2048, 13)
    tmin = jnp.zeros((2048, 1))
    tmax = jnp.full((2048, 1), 1e30)

    monkeypatch.setattr(cl, "_split_batches", lambda Q, s: max(1, int(s)))
    monkeypatch.setattr(cl, "SPLIT_CLOSEST", 1)
    monkeypatch.setattr(cl, "SPLIT_ANYHIT", 1)
    bt0, g0, u0, v0, novf0 = jax.jit(cl._traverse_compact)(
        cb, ro, rd, tmin, tmax)
    occ0, novfo0 = jax.jit(cl._traverse_compact_anyhit)(
        cb, ro, rd, tmin, jnp.full((2048, 1), 2.0))
    assert int(np.asarray(novf0)) == 0 and int(np.asarray(novfo0)) == 0

    for k in (2, 4):
        monkeypatch.setattr(cl, "SPLIT_CLOSEST", k)
        monkeypatch.setattr(cl, "SPLIT_ANYHIT", k)
        bt, g, u, v, novf = jax.jit(cl._traverse_compact)(
            cb, ro, rd, tmin, tmax)
        occ, novfo = jax.jit(cl._traverse_compact_anyhit)(
            cb, ro, rd, tmin, jnp.full((2048, 1), 2.0))
        assert int(np.asarray(novf)) == 0 and int(np.asarray(novfo)) == 0
        np.testing.assert_array_equal(np.asarray(bt0), np.asarray(bt))
        np.testing.assert_array_equal(np.asarray(g0), np.asarray(g))
        np.testing.assert_array_equal(np.asarray(u0), np.asarray(u))
        np.testing.assert_array_equal(np.asarray(v0), np.asarray(v))
        np.testing.assert_array_equal(np.asarray(occ0), np.asarray(occ))


def _pair_case(case, seed=0):
    """Synthetic (Q, K) candidate sets through the production flattening
    (_flat_pairs), with per-(ray, cluster) test results chosen to stress
    one property of the reduce."""
    rng = np.random.default_rng(seed)
    Q, K, C = 64, 6, 40
    live = rng.random((Q, K)) < 0.6
    if case == "no_pairs":
        live[rng.random(Q) < 0.5] = False      # half the rays: no pairs
    cand = np.stack([rng.permutation(C)[:K] for _ in range(Q)]).astype(
        np.int32)
    t_tab = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), size=(Q, C))
    if case == "ties":
        t_tab[:] = rng.choice(np.float32([1.0, 2.0]), size=(Q, C))
    miss = rng.random((Q, C)) < (0.6 if case == "anyhit" else 0.2)
    t_tab = np.where(miss, cl.INF, t_tab).astype(np.float32)
    g_tab = (np.arange(C, dtype=np.int32)[None, :] * 7919
             + rng.integers(0, 5, (Q, 1), dtype=np.int32)) % 100003
    u_tab = rng.random((Q, C), dtype=np.float32)
    v_tab = rng.random((Q, C), dtype=np.float32)
    budget = int(live.sum()) // 2 if case == "budget" else Q * K
    rayP, cidP, _, cnt, lost = cl._flat_pairs(
        jnp.asarray(cand), jnp.asarray(live), Q, budget)
    if case == "budget":
        assert int(np.asarray(lost).sum()) > 0
    rayc = np.minimum(np.asarray(rayP), Q - 1)
    cid = np.asarray(cidP)
    ok = np.asarray(rayP) < Q
    t_p = np.where(ok, t_tab[rayc, cid], cl.INF).astype(np.float32)
    return (rayP, t_p, g_tab[rayc, cid], u_tab[rayc, cid], v_tab[rayc, cid],
            cnt, Q)


@pytest.mark.parametrize("case", ["ties", "no_pairs", "budget", "anyhit"])
def test_pair_reduce_matches_numpy(case):
    """The per-ray pair reduce against a numpy reference: equal-t ties go
    to the lowest gid, rays with no pairs (or only misses) report no hit,
    pairs past the budget are never read, any-hit is 'some pair hit'."""
    rayP, t_p, g_p, u_p, v_p, cnt, Q = _pair_case(case)
    ref = cl.pair_reduce_reference(rayP, t_p, g_p, u_p, v_p, Q)
    got = jax.jit(cl._reduce_closest)(rayP, jnp.asarray(t_p),
                                      jnp.asarray(g_p), jnp.asarray(u_p),
                                      jnp.asarray(v_p), cnt)
    for name, r, g in zip(("t", "gid", "u", "v"), ref[:4], got):
        np.testing.assert_array_equal(r, np.asarray(g), err_msg=name)
    occ = jax.jit(cl._reduce_anyhit)(rayP, jnp.asarray(t_p), cnt)
    np.testing.assert_array_equal(ref[4], np.asarray(occ))
    if case == "ties":  # the tie rule was exercised
        assert (np.asarray(g_p)[np.asarray(t_p) == 1.0].size > 0)


def test_traversal_reduce_matches_numpy(setups):
    """The production pair list of a real traversal (big scene): the
    traversal's reduce equals the numpy reference in t, gid, u, v and
    occluded, bit for bit."""
    scene, cb = setups["big"]
    cb = jax.tree.map(jnp.asarray, cb)
    Q = 1024
    ro, rd = _rays(Q, 29)
    tmin = jnp.zeros((Q,))
    tmax = jnp.full((Q,), 1e30)

    @jax.jit
    def pairs(cb, ro, rd):
        cand, live, _ = cl._descend_compact(cb, ro, 1.0 / rd, tmin[:, None],
                                            tmax[:, None])
        rayP, cidP, _, cnt, _ = cl._flat_pairs(
            cand, live, Q, int(cb.pair_mults[2] * Q))
        t_p, u_p, v_p, g_p = cl._test_pair_batch(
            cb, ro, rd, tmin, tmax, jnp.minimum(rayP, Q - 1), cidP,
            rayP < Q)
        return (rayP, t_p, g_p, u_p, v_p,
                cl._reduce_closest(rayP, t_p, g_p, u_p, v_p, cnt),
                cl._reduce_anyhit(rayP, t_p, cnt))

    rayP, t_p, g_p, u_p, v_p, got, occ = pairs(cb, ro, rd)
    ref = cl.pair_reduce_reference(rayP, t_p, g_p, u_p, v_p, Q)
    assert ref[4].sum() > Q // 4                      # real hits exercised
    for name, r, g in zip(("t", "gid", "u", "v"), ref[:4], got):
        np.testing.assert_array_equal(r, np.asarray(g), err_msg=name)
    np.testing.assert_array_equal(ref[4], np.asarray(occ))


def test_device_build_refined_tiny_scene(setups):
    """SAH window refinement edge case: a scene smaller than one tile
    (C=1 window -> 2 chunk slots, caps clamped to the table size) still
    intersects exactly."""
    scene, _ = setups["cornell"]
    cb = jax.jit(cl.build_cluster_device)(scene)   # default tile=128
    assert cb.n_clusters == 2
    ro, rd = _rays(256, 31)
    tmin = jnp.zeros((256, 1))
    tmax = jnp.full((256, 1), 1e30)
    h_ref = brute.intersect(scene, ro, rd, tmin, tmax)
    h_cl = cl.intersect(cb, scene, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h_ref.hit), np.asarray(h_cl.hit))
    m = np.asarray(h_ref.hit)[:, 0]
    np.testing.assert_allclose(
        np.asarray(h_ref.t)[m], np.asarray(h_cl.t)[m], rtol=1e-5, atol=1e-6)
