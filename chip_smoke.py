"""Proof that the renderer runs, and renders right, on NVIDIA GPUs.

Run from the root of the checkout, as the only JAX process on its cards:

    python chip_smoke.py              # one GPU: the six phases below
    python chip_smoke.py --four-gpus  # four GPUs: sharded render + grad only

One GPU, in this order (one process; the CLI runs in process):
  device   JAX's backend is "gpu"; the card's name and power limit.
  oracle   cornell-spheres 128², spp 8, depth 4: the wavefront cluster
           render against the brute-force oracle; one CLI render.
  reduce   the traversal's per-ray pair reduce (segment min) on big-1m
           camera rays at Q = 4096 against the sort reduce it replaced
           and a numpy reference, bit for bit.
  forward  the bench cell (big-1m, 1024², spp 1, depth 4, queue 4096, host
           SAH build) with verify-then-retry, timed; on a 128² crop of the
           same camera, cluster hits against the exact packed walk.
  device_build  the jitted device cluster build at big-1m, then a 256²
           render against the host-build render.
  grad     loss_and_grad_wavefront at big-1m 256²; the Cornell emission
           finite-difference check of tests/test_diff.py.

Four GPUs: render_sharded(fast=True) and loss_and_grad_sharded on a 4-card
mesh against the single-device render and grad, at Cornell and big-1m 256².

Every phase prints one line with its numbers; a failed phase prints its
traceback and the script goes on to the next.  The last line of standard
output is one JSON object: {"ok": true, "device": {...}} when every phase
passed, {"ok": false, ...} otherwise.  Without a GPU the script exits with
code 2 and prints no result.  Images go to <checkout>/build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import time
import traceback

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")

# Oracle tolerance, 5x the CPU gate of tests/test_cluster.py (2e-4/2e-5):
# on the GPU the spp-8 sums are scatter-added in a run-dependent atomic
# order, and XLA contracts multiply-adds into FMAs differently in the brute
# and cluster programs; 4 of 16,384 pixels exceeded the CPU gate (max
# |diff| 2.2e-4 at radiance ~1) on an H100.
ORACLE_RTOL, ORACLE_ATOL = 1e-3, 1e-4
# Cluster vs packed-walk hit distance on the same primitive: the two
# intersectors evaluate Möller–Trumbore with different operation orders, so
# t may differ in the last bits.
T_ULP_BOUND = 8
# Sharded vs single-device render and grads: tests/test_dist.py's gates.
DIST_RTOL, DIST_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-5


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class Ctx:
    """Sizes and the shared big-scene state (built once, on first use)."""

    def __init__(self, scene: str = "big-1m", size: int = 1024,
                 small: int = 256, crop: int = 128, queue: int = 4096,
                 cornell: int = 128):
        self.scene_name, self.size, self.small = scene, size, small
        self.crop, self.queue, self.cornell = crop, queue, cornell

    @functools.cached_property
    def big(self):
        """(host scene, device scene, host cluster BVH, build seconds)."""
        import jax

        from bench import load_scene
        from tpu_pt.bvh.cluster import build_cluster_bvh

        scene, _ = load_scene(self.scene_name, self.size)
        t0 = time.time()
        cb = build_cluster_bvh(scene)
        return scene, jax.device_put(scene), cb, time.time() - t0

    def camera(self, size: int):
        from tpu_pt.scene import meshes

        return meshes.big_camera(size, size)


def _img_compare(a, b, rtol, atol) -> dict:
    a, b = np.asarray(a), np.asarray(b)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol).all(-1)
    return {"max_abs_diff": float(np.abs(a - b).max()),
            "pixels_outside_tol": int(bad.sum()),
            "mean_a": float(a.mean()), "mean_b": float(b.mean())}


def phase_oracle(ctx: Ctx) -> dict:
    import jax

    from tpu_pt import cli
    from tpu_pt.bvh.cluster import build_cluster_bvh
    from tpu_pt.config import RenderConfig
    from tpu_pt.render.driver import render
    from tpu_pt.render.wavefront import render_wavefront_counts
    from tpu_pt.scene import cornell

    n = ctx.cornell
    scene = cornell.cornell("spheres")
    cam = cornell.camera(n, n)
    cfg = RenderConfig(width=n, height=n, spp=8, max_depth=4)
    key = jax.random.key(3)
    t0 = time.time()
    img, _, _, novf, _ = render_wavefront_counts(
        jax.device_put(scene), cam, cfg, key,
        jax.device_put(build_cluster_bvh(scene)), queue=ctx.queue,
        backend="cluster")
    img = np.asarray(img)
    t_wave = time.time() - t0
    _check(int(novf) == 0, f"cornell render overflowed by {int(novf)}")
    t0 = time.time()
    ref = render(scene, cam, cfg, key, backend="brute")
    t_brute = time.time() - t0
    out = _img_compare(img, ref, ORACLE_RTOL, ORACLE_ATOL)
    out.update(wavefront_s=t_wave, brute_s=t_brute)
    _check(np.isfinite(img).all(), "non-finite wavefront radiance")
    _check(out["pixels_outside_tol"] == 0,
           f"cluster render differs from the oracle: {out}")

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "cornell_cli.png")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["render", "cornell-spheres", "-r", str(n), str(n),
                       "-s", "8", "-m", "4", "--seed", "3",
                       "--queue", str(ctx.queue), "-f", png])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    _check(rc == 0 and os.path.getsize(png) > 0, "CLI wrote no PNG")
    _check(np.isfinite(rec["mean_radiance"]), f"CLI radiance: {rec}")
    _check(rec["overflow"] == 0, f"CLI overflow: {rec}")
    # Same seed, scene and queue as the render above: same image.
    _check(abs(rec["mean_radiance"] - float(img.mean())) <= 1e-5,
           f"CLI mean {rec['mean_radiance']} vs {float(img.mean())}")
    out.update(cli_mean_radiance=rec["mean_radiance"],
               cli_seconds=rec["seconds"])
    return out


def _camera_rays(cam, size: int, pixels):
    import jax.numpy as jnp

    from tpu_pt.core.camera import generate_rays, pixel_xy

    xy = pixel_xy(size, size, jnp.asarray(pixels, jnp.int32),
                  jnp.full((len(pixels), 2), 0.5, jnp.float32))
    return generate_rays(cam, xy)


def _sort_reduce(rayP, t_p, g_p, u_p, v_p, cnt):
    """The traversal's former per-ray reduce, kept as a reference: one
    3-key (ray, t, gid) sort of the pair list, read at segment heads."""
    import jax
    import jax.numpy as jnp

    from tpu_pt.bvh.cluster import INF

    P = rayP.shape[0]
    g_key = jnp.where(t_p < INF, g_p, jnp.int32(2**31 - 1))
    _, tS, gS, uS, vS = jax.lax.sort((rayP, t_p, g_key, u_p, v_p),
                                     dimension=0, num_keys=3)
    head = jnp.minimum(jnp.cumsum(cnt) - cnt, P - 1)
    has = (cnt > 0) & (tS[head] < INF)
    occ = jnp.zeros(cnt.shape, jnp.int32).at[rayP].add(
        (t_p < INF).astype(jnp.int32), mode="drop") > 0
    return (jnp.where(has, tS[head], INF), jnp.where(has, gS[head], 0),
            jnp.where(has, uS[head], 0.0), jnp.where(has, vS[head], 0.0),
            (cnt > 0) & occ)


def phase_reduce(ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from tpu_pt.bvh import cluster as cl

    scene, _, cb, _ = ctx.big
    cb_d = jax.device_put(cb)
    Q = ctx.queue
    n_pix = ctx.size * ctx.size
    ro, rd = _camera_rays(ctx.camera(ctx.size), ctx.size,
                          np.arange(Q) * (n_pix // Q))
    tmin = jnp.zeros((Q,))
    tmax = jnp.full((Q,), cl.INF)

    @jax.jit
    def pairs(cb, ro, rd):
        cand, live, ovf = cl._descend_compact(cb, ro, 1.0 / rd,
                                              tmin[:, None], tmax[:, None])
        rayP, cidP, dropped, cnt, _ = cl._flat_pairs(
            cand, live, Q, int(cb.pair_mults[2] * Q))
        t_p, u_p, v_p, g_p = cl._test_pair_batch(
            cb, ro, rd, tmin, tmax, jnp.minimum(rayP, Q - 1), cidP,
            rayP < Q)
        return rayP, t_p, g_p, u_p, v_p, cnt, jnp.sum(ovf) + dropped

    rayP, t_p, g_p, u_p, v_p, cnt, novf = pairs(cb_d, ro, rd)
    got = (*jax.jit(cl._reduce_closest)(rayP, t_p, g_p, u_p, v_p, cnt),
           jax.jit(cl._reduce_anyhit)(rayP, t_p, cnt))
    refs = {"sort": jax.jit(_sort_reduce)(rayP, t_p, g_p, u_p, v_p, cnt),
            "numpy": cl.pair_reduce_reference(rayP, t_p, g_p, u_p, v_p, Q)}
    for ref_name, ref in refs.items():
        for name, r, g in zip(("t", "gid", "u", "v", "occluded"), ref, got):
            _check(np.array_equal(np.asarray(r), np.asarray(g)),
                   f"reduce differs from the {ref_name} reduce in {name}")
    out = {"pairs": int((np.asarray(rayP) < Q).sum()),
           "hits": int(np.asarray(got[4]).sum()), "overflow": int(novf)}
    _check(out["hits"] > Q // 2, f"too few camera hits: {out}")
    return out


def phase_forward(ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from bench import timed_render
    from tpu_pt.bvh import cluster as cl
    from tpu_pt.bvh import packed as pk
    from tpu_pt.bvh.native import build_packed
    from tpu_pt.config import RenderConfig

    scene, scene_d, cb, t_build = ctx.big
    cam = ctx.camera(ctx.size)
    cfg = RenderConfig(width=ctx.size, height=ctx.size, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    img, d = timed_render(scene_d, cam, cfg, cb, scene, ctx.queue)
    _check(d["overflow"] == 0 or d["exact_retry"],
           f"overflow {d['overflow']} not repaired")
    _check(np.isfinite(np.asarray(img)).all(), "non-finite radiance")
    out = dict(d, bvh_build_s=t_build)

    # Exactness on a centre crop: cluster hits vs the exact packed walk.
    lo = (ctx.size - ctx.crop) // 2
    rows = np.arange(lo, lo + ctx.crop)
    pix = (rows[:, None] * ctx.size + rows[None, :]).reshape(-1)
    ro, rd = _camera_rays(cam, ctx.size, pix)
    R = len(pix)
    tmin = jnp.zeros((R, 1))
    tmax = jnp.full((R, 1), cl.INF)
    isect = jax.jit(cl.intersect_counted)
    h_c, novf = isect(jax.device_put(cb), scene_d, ro, rd, tmin, tmax)
    if int(novf):  # a coherent crop can exceed the budgets: repair exactly
        h_c, _ = isect(jax.device_put(cl.attach_fallback(cb, scene)),
                       scene_d, ro, rd, tmin, tmax)
    h_p = jax.jit(pk.intersect)(jax.device_put(build_packed(scene)),
                                scene_d, ro, rd, tmin, tmax)
    hit_c, hit_p = np.asarray(h_c.hit)[:, 0], np.asarray(h_p.hit)[:, 0]
    _check(np.array_equal(hit_c, hit_p),
           f"hit masks differ on {int((hit_c != hit_p).sum())} rays")
    t_c = np.asarray(h_c.t)[hit_c, 0]
    t_p = np.asarray(h_p.t)[hit_p, 0]
    same = np.asarray(h_c.prim)[hit_c] == np.asarray(h_p.prim)[hit_p]
    ulps = np.abs(t_c - t_p) / np.spacing(t_p)
    out.update(crop_rays=R, crop_hits=int(hit_c.sum()),
               crop_overflow=int(novf), crop_prim_agree=float(same.mean()),
               crop_max_t_ulp_same_prim=float(ulps[same].max()),
               crop_max_t_rel_other_prim=float(
                   (np.abs(t_c - t_p) / t_p)[~same].max(initial=0.0)))
    _check(out["crop_max_t_ulp_same_prim"] <= T_ULP_BOUND,
           f"t differs by more than {T_ULP_BOUND} ulp: {out}")
    # Where the two walks pick different primitives, the ray passes a
    # shared edge or coincident surfaces: rare, and at equal depth.
    _check(same.mean() >= 0.999 and out["crop_max_t_rel_other_prim"] <= 1e-4,
           f"the walks disagree on the nearest primitive: {out}")
    return out


def phase_device_build(ctx: Ctx) -> dict:
    import jax

    from bench import timed_render
    from tpu_pt.bvh.cluster import build_cluster_device
    from tpu_pt.config import RenderConfig

    scene, scene_d, cb_host, _ = ctx.big
    build = jax.jit(build_cluster_device)
    t0 = time.time()
    cb_dev = jax.block_until_ready(build(scene_d))
    t_first = time.time() - t0
    t0 = time.time()
    cb_dev = jax.block_until_ready(build(scene_d))
    t_rebuild = time.time() - t0
    n = ctx.small
    cam = ctx.camera(n)
    cfg = RenderConfig(width=n, height=n, spp=1, max_depth=4, rr_start=2,
                       rr_prob=0.7)
    img_dev, d_dev = timed_render(scene_d, cam, cfg, cb_dev, scene,
                                  ctx.queue, runs=1)
    img_host, d_host = timed_render(scene_d, cam, cfg, cb_host, scene,
                                    ctx.queue, runs=1)
    out = _img_compare(img_dev, img_host, ORACLE_RTOL, ORACLE_ATOL)
    out.update(build_compile_plus_run_s=t_first, rebuild_s=t_rebuild,
               clusters=int(cb_dev.n_clusters),
               overflow=d_dev["overflow"], exact_retry=d_dev["exact_retry"],
               rays_per_s=d_dev["rays_per_s"],
               host_build_rays_per_s=d_host["rays_per_s"])
    _check(d_dev["overflow"] == 0 or d_dev["exact_retry"],
           "device-build overflow not repaired")
    _check(out["pixels_outside_tol"] == 0,
           f"device-build image differs from the host-build image: {out}")
    return out


def phase_grad(ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from tpu_pt.config import RenderConfig
    from tpu_pt.diff.adjoint import loss_and_grad_wavefront, render_flat
    from tpu_pt.diff.params import merge, split
    from tpu_pt.scene import cornell

    scene, scene_d, cb, _ = ctx.big
    n = ctx.small
    cam = ctx.camera(n)
    cfg = RenderConfig(width=n, height=n, spp=1, max_depth=4, rr_start=2,
                       rr_prob=0.7)
    params, _ = split(scene_d)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    step = jax.jit(loss_and_grad_wavefront,
                   static_argnames=("cfg", "backend", "queue"))
    cb_d = jax.device_put(cb)
    times = []
    for i in range(2):
        t0 = time.time()
        loss, grads = step(params, scene_d, cam, cfg, jax.random.key(i),
                           target, cb_d, backend="cluster", queue=ctx.queue)
        loss = float(loss)
        times.append(time.time() - t0)
        _check(np.isfinite(loss), f"loss {loss}")
        for k, g in grads.items():
            _check(np.isfinite(np.asarray(g)).all(), f"non-finite grad {k}")
    out = {"loss": loss, "compile_plus_run_s": times[0], "run_s": times[1]}

    # tests/test_diff.py::test_emission_grad_on_emissive_cornell, on the GPU.
    scene = cornell.cornell("empty")
    cam = cornell.camera(8, 8)
    cfg = RenderConfig(width=8, height=8, spp=2, direct_only=True)
    key = jax.random.key(1)
    params, _ = split(scene)
    w_mat = jnp.ones((cfg.n_pixels, 3))

    def scalar(p):
        return jnp.sum(render_flat(merge(p, scene), cam, cfg, key) * w_mat)

    g_em = float(np.asarray(jax.grad(scalar)(params)["emission"])[3, 0])
    eps = 0.5

    def eval_at(delta):
        arr = np.asarray(params["emission"]).copy()
        arr[3, 0] += delta
        return float(scalar(dict(params, emission=jnp.asarray(arr))))

    fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
    out.update(cornell_emission_grad=g_em, cornell_fd=fd)
    np.testing.assert_allclose(g_em, fd, rtol=2e-2)
    return out


def _dist_cases(ctx: Ctx):
    """(name, host scene, camera, config, exact cluster BVH) for 4 GPUs.

    The BVHs carry the exact fallback: a sharded render batches other rays
    together than a single-device one, so without it the two would drop
    different overflowed candidates (big-1m 256² overflows its budgets)."""
    from tpu_pt.bvh.cluster import attach_fallback, build_cluster_bvh
    from tpu_pt.config import RenderConfig
    from tpu_pt.scene import cornell

    scene_c = cornell.cornell("spheres")
    n = ctx.cornell
    yield ("cornell", scene_c, cornell.camera(n, n),
           RenderConfig(width=n, height=n, spp=8, max_depth=4),
           attach_fallback(build_cluster_bvh(scene_c), scene_c))
    scene, _, cb, _ = ctx.big
    n = ctx.small
    yield (ctx.scene_name, scene, ctx.camera(n),
           RenderConfig(width=n, height=n, spp=1, max_depth=4, rr_start=2,
                        rr_prob=0.7), attach_fallback(cb, scene))


def phase_sharded_render(ctx: Ctx) -> dict:
    import jax

    from tpu_pt.dist.sharding import make_mesh, render_sharded
    from tpu_pt.render.wavefront import render_wavefront_counts

    mesh = make_mesh(4)
    key = jax.random.key(2)
    out = {}
    for name, scene, cam, cfg, cb in _dist_cases(ctx):
        scene_d, cb_d = jax.device_put(scene), jax.device_put(cb)
        t0 = time.time()
        img_sh = np.asarray(render_sharded(scene_d, cam, cfg, key, cb_d,
                                           mesh, queue=ctx.queue,
                                           backend="cluster", fast=True))
        t_sh = time.time() - t0
        img_1 = np.asarray(render_wavefront_counts(
            scene_d, cam, cfg, key, cb_d, queue=ctx.queue,
            backend="cluster")[0])
        cmp = _img_compare(img_sh, img_1, DIST_RTOL, DIST_ATOL)
        out[name] = dict(cmp, sharded_compile_plus_run_s=t_sh,
                         bit_identical=bool(np.array_equal(img_sh, img_1)))
        _check(cmp["pixels_outside_tol"] == 0,
               f"{name}: sharded render differs: {cmp}")
    return out


def phase_sharded_grad(ctx: Ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from tpu_pt.diff.adjoint import loss_and_grad_wavefront
    from tpu_pt.diff.params import split
    from tpu_pt.dist.sharding import loss_and_grad_sharded, make_mesh

    mesh = make_mesh(4)
    key = jax.random.key(2)
    out = {}
    for name, scene, cam, cfg, cb in _dist_cases(ctx):
        scene_d, cb_d = jax.device_put(scene), jax.device_put(cb)
        params, _ = split(scene_d)
        target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
        t0 = time.time()
        loss_sh, g_sh = loss_and_grad_sharded(
            params, scene_d, cam, cfg, key, target, cb_d, mesh,
            queue=ctx.queue, backend="cluster")
        loss_sh = float(loss_sh)
        t_sh = time.time() - t0
        loss_1, g_1 = jax.jit(loss_and_grad_wavefront,
                              static_argnames=("cfg", "backend", "queue"))(
            params, scene_d, cam, cfg, key, target, cb_d,
            backend="cluster", queue=ctx.queue)
        rec = {"loss_sharded": loss_sh, "loss_single": float(loss_1),
               "sharded_compile_plus_run_s": t_sh}
        np.testing.assert_allclose(loss_sh, float(loss_1), rtol=LOSS_RTOL)
        for k in g_1:
            a, b = np.asarray(g_sh[k]), np.asarray(g_1[k])
            rec[f"max_abs_diff_{k}"] = float(np.abs(a - b).max())
            np.testing.assert_allclose(a, b, rtol=DIST_RTOL, atol=DIST_ATOL,
                                       err_msg=f"{name} grad {k}")
        out[name] = rec
    return out


ONE_GPU = [("oracle", phase_oracle), ("reduce", phase_reduce),
           ("forward", phase_forward), ("device_build", phase_device_build),
           ("grad", phase_grad)]
FOUR_GPUS = [("sharded_render", phase_sharded_render),
             ("sharded_grad", phase_sharded_grad)]


def run_phases(phases, ctx: Ctx) -> list:
    """Run each phase, print its line; return the names that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.time()
        try:
            out = fn(ctx)
        except Exception:
            traceback.print_exc()
            print(f"{name}: FAIL after {time.time() - t0:.1f} s", flush=True)
            failed.append(name)
            continue
        print(f"{name}: ok {time.time() - t0:.1f} s {json.dumps(out)}",
              flush=True)
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded render and grad on 4 GPUs")
    args = p.parse_args(argv)
    t_start = time.time()
    import jax

    if jax.default_backend() != "gpu":
        print(f"device: FAIL — JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    n_dev = 4 if args.four_gpus else 1
    if len(jax.devices()) < n_dev:
        print(f"device: FAIL — {n_dev} GPUs needed, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    from tpu_pt.cli import enable_compile_cache, gpu_info

    cache = enable_compile_cache()
    print(gpu_info())
    print(f"device: ok {jax.devices()} jax {jax.__version__} "
          f"compile cache {cache}", flush=True)
    failed = run_phases(FOUR_GPUS if args.four_gpus else ONE_GPU, Ctx())
    print(f"wall: {time.time() - t_start:.1f} s", flush=True)
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
