"""Benchmark harness — BASELINE.json primary metric, on one GPU.

Prints ONE JSON line:
  {"metric": "rays_per_s_per_chip", "value": N, "unit": "rays/s",
   "detail": {...}}

Metric definition (BASELINE.json): rays/s/chip counting primary + bounce
path segments on a Sponza-class (~1M-triangle) scene at 1024², 4-bounce path
tracing with Russian roulette.  "Rays" = path segments actually traced
(primary + secondary + shadow), the same accounting the reference's writeup
used for its rays/s numbers (SURVEY.md §6).  ``detail`` names the device
(JAX platform, device kind and count) and the card with its power limit, as
``nvidia-smi --query-gpu=name,power.limit`` reports them.  There is no CPU
fallback: without a GPU the benchmark exits with an error.

Environment knobs:
  BENCH_BACKEND (default "cluster") cluster | packed | bvh
  BENCH_SCENE   (default "big-1m")  big=327k tris, big-1m=1.3M tris,
                                    atrium=1.04M-tri architectural interior
  BENCH_SIZE    (default 1024)      image side (config 3 headline = 1024)
  BENCH_SPP     (default 1)
  BENCH_QUEUE   (default 4096)
  BENCH_BVH     (default "sah")     sah (host native) | lbvh (device build)
  BENCH_GRAD=1  measure the DIFFERENTIABLE step instead (forward wavefront
                render + adjoint sweep + parameter grads, BASELINE config 4);
                reports grad_rays_per_s = path segments / (fwd+bwd seconds).
                Default size drops to 256 unless BENCH_SIZE is set.
The compile cache follows JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache
(tpu_pt.cli.enable_compile_cache).
"""

from __future__ import annotations

import json
import os
import sys
import time


def load_scene(name: str, size: int):
    """(host scene, camera) of a bench scene at a square resolution."""
    from tpu_pt.scene import meshes

    if name == "atrium":
        # Architectural interior (~1M tris): colonnades, coffered ceiling,
        # skylight area lights — Sponza-class depth complexity.
        return meshes.atrium_scene(), meshes.atrium_camera(size, size)
    subdiv = {"big": 7, "big-1m": 8}[name]
    return meshes.big_scene(subdiv=subdiv), meshes.big_camera(size, size)


def device_detail() -> dict:
    """The device a result was measured on, as JAX and nvidia-smi see it."""
    import jax

    from tpu_pt.cli import gpu_info

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "gpu": gpu_info()}


def timed_render(scene_d, cam, cfg, packed, scene_host, queue: int,
                 backend: str = "cluster", runs: int = 3):
    """Forward wavefront render with verify-then-retry exactness, timed.

    The first run compiles and MEASURES the capacity contract end to end;
    only if it overflowed is the exact path paid for — a re-render with the
    packed-walk fallback attached (overflowed rays re-traced exactly).  Each
    of ``runs`` timed runs is checked the same way: a timed run that
    overflows without the fallback attaches it, re-warms and restarts the
    timing, so the reported time always belongs to an exact render.  Every
    run ends by fetching scalars of the result to the host, which waits for
    the device.  Returns (image, detail dict) with the median run time."""
    import jax
    import numpy as np

    from tpu_pt.bvh.cluster import attach_fallback
    from tpu_pt.render.wavefront import render_wavefront_counts

    packed_d = jax.device_put(packed)

    def run(k):
        img, nc, ns, novf, ni = render_wavefront_counts(
            scene_d, cam, cfg, k, packed_d, queue=queue, backend=backend)
        # Sync on scalar fetches only (image download stays off the clock).
        return (img, float(np.asarray(nc)), float(np.asarray(ns)),
                int(np.asarray(novf)), int(np.asarray(ni)))

    def attach_exact():
        nonlocal packed_d
        packed_d = jax.device_put(attach_fallback(packed, scene_host))

    key = jax.random.key(0)
    t0 = time.time()
    img, n_closest, n_shadow, n_ovf, n_iter = run(key)
    t_compile_run = time.time() - t0
    exact_retry = False
    if n_ovf and backend == "cluster":
        print(f"# note: {n_ovf} candidates overflowed; re-rendering with "
              "the exact fallback attached", file=sys.stderr)
        attach_exact()
        exact_retry = True
        t0 = time.time()
        img, n_closest, n_shadow, n_ovf, n_iter = run(key)
        t_compile_run += time.time() - t0

    while True:
        times, ovf_runs = [], []
        for i in range(1, runs + 1):
            t0 = time.time()
            img, n_closest, n_shadow, n_ovf, n_iter = run(jax.random.key(i))
            times.append(time.time() - t0)
            ovf_runs.append(n_ovf)
            if n_ovf and not exact_retry and backend == "cluster":
                break
        if not any(ovf_runs) or exact_retry or backend != "cluster":
            break
        print(f"# note: timed run overflowed ({ovf_runs[-1]} candidates); "
              "attaching the exact fallback and restarting timing",
              file=sys.stderr)
        attach_exact()
        exact_retry = True
        t0 = time.time()
        img, n_closest, n_shadow, n_ovf, n_iter = run(key)  # re-warm
        t_compile_run += time.time() - t0
    dt = sorted(times)[len(times) // 2]
    rays = n_closest + n_shadow
    return img, {
        "rays_per_s": rays / dt,
        "overflow": int(max(ovf_runs)),
        "exact_retry": exact_retry,
        "steps_run": int(n_iter),
        "n_closest": int(n_closest),
        "n_shadow": int(n_shadow),
        "compile_plus_run_s": t_compile_run,
        "run_s": dt,
        "run_s_all": times,
        "mean_radiance": float(np.asarray(img).mean()),
    }


def main() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX found "
                         f"{jax.default_backend()!r} only")
    from tpu_pt.cli import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from tpu_pt.config import RenderConfig
    from tpu_pt.render.wavefront import n_steps, render_wavefront_counts

    scene_name = os.environ.get("BENCH_SCENE", "big-1m")
    grad_mode = bool(os.environ.get("BENCH_GRAD"))
    size = int(os.environ.get("BENCH_SIZE", "256" if grad_mode else "1024"))
    spp = int(os.environ.get("BENCH_SPP", "1"))
    queue = int(os.environ.get("BENCH_QUEUE", str(1 << 12)))
    scene, cam = load_scene(scene_name, size)  # host (numpy) pytree
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=4,
                       rr_start=2, rr_prob=0.7)

    backend = os.environ.get("BENCH_BACKEND", "cluster")
    if os.environ.get("BENCH_SPLIT") or os.environ.get("BENCH_SPLIT_ANYHIT"):
        # Intra-batch traversal split A/B: override the defaults in
        # cluster.py.
        from tpu_pt.bvh import cluster as _cl

        if os.environ.get("BENCH_SPLIT"):
            _cl.SPLIT_CLOSEST = _cl.SPLIT_ANYHIT = int(
                os.environ["BENCH_SPLIT"])
        if os.environ.get("BENCH_SPLIT_ANYHIT"):
            _cl.SPLIT_ANYHIT = int(os.environ["BENCH_SPLIT_ANYHIT"])
    if os.environ.get("BENCH_STEP_SLICES"):
        from tpu_pt.render import wavefront as _wf

        _wf.STEP_SLICES = int(os.environ["BENCH_STEP_SLICES"])
    if os.environ.get("BENCH_ANYHIT_MULT"):
        from tpu_pt.bvh import cluster as _cl

        _cl.ANYHIT_MULT = int(os.environ["BENCH_ANYHIT_MULT"])

    bvh_kind = os.environ.get("BENCH_BVH", "sah")
    t0 = time.time()
    if backend == "cluster":
        pb = os.environ.get("BENCH_PB")
        pb = int(pb) if pb else None
        if bvh_kind == "lbvh":  # device Morton-chunk build (config 3)
            from tpu_pt.bvh.cluster import build_cluster_device

            cs = float(os.environ.get("BENCH_LBVH_SCALE", "1.35"))
            tau = os.environ.get("BENCH_LBVH_TAU")  # "none" disables refine
            tau = (None if tau and tau.lower() == "none"
                   else float(tau) if tau else 0.5)
            packed = jax.jit(build_cluster_device,
                             static_argnames=("pair_budget", "cap_scale"))(
                jax.device_put(scene), pair_budget=pb, cap_scale=cs,
                split_tau=tau)
            jax.block_until_ready(packed)
        elif os.environ.get("BENCH_AUTOTUNE"):
            # Frontier caps + pair budget sized from probe runs of the REAL
            # wavefront (warmed mixed-depth population across the image).
            # Exactness is then enforced by verify-then-retry, not an
            # always-attached fallback.
            from tpu_pt.bvh.cluster import autotune_for_render

            packed = autotune_for_render(scene, cam, cfg, queue=queue,
                                         pair_budget=pb,
                                         exact_fallback=False)
            print(f"# autotuned frontiers: {packed.frontiers} "
                  f"pair_mults: {packed.pair_mults}")
        else:
            from tpu_pt.bvh.cluster import build_cluster_bvh

            tile = int(os.environ.get("BENCH_TILE", "128"))
            ds = int(os.environ.get("BENCH_DENSE_START", "512"))
            packed = build_cluster_bvh(scene, tile=tile, pair_budget=pb,
                                       dense_start=ds)
    elif bvh_kind == "lbvh":
        from tpu_pt.bvh.lbvh import build_lbvh

        packed = jax.block_until_ready(build_lbvh(scene))
    else:
        from tpu_pt.bvh.native import build_packed

        packed = build_packed(scene)
    t_build = time.time() - t0

    pm_env = os.environ.get("BENCH_PAIR_MULTS")
    if pm_env and backend == "cluster":
        # A/B: rebuild the ClusterBVH with explicit pair mults, e.g.
        # BENCH_PAIR_MULTS=8,8,5,4 (top, mid, leaf, any-hit narrow).
        from tpu_pt.bvh.cluster import ClusterBVH

        pm = tuple(float(x) if "." in x else int(x)
                   for x in pm_env.split(","))
        packed = ClusterBVH(packed.levels, packed.tiles, packed.tile_gid,
                            packed.frontiers, packed.k_leaf,
                            packed.pair_budget, pair_mults=pm,
                            levels16=packed.levels16,
                            fallback=packed.fallback)
        print(f"# pair_mults override: {packed.pair_mults}")

    scene_d = jax.device_put(scene)  # one-shot host→device upload
    key = jax.random.key(0)

    if grad_mode:
        # BASELINE config 4: the differentiable step through the production
        # path (remat-chunked wavefront scan + cluster intersector).
        from tpu_pt.diff.adjoint import loss_and_grad_wavefront
        from tpu_pt.diff.params import split

        packed_d = jax.device_put(packed)
        params, _ = split(scene_d)
        target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)

        # Measured forward path-segment counts (same accounting as the
        # forward bench); the adjoint revisits every segment.
        _, nc, ns_, _, n_iter = render_wavefront_counts(
            scene_d, cam, cfg, key, packed_d, queue=queue, backend=backend)
        n_closest = float(np.asarray(nc))
        n_shadow = float(np.asarray(ns_))
        # Tighter static scan bound from the MEASURED executed-step count
        # (the worst-case bound pads the grad scan ~2.8x).  +20% slack
        # covers key-to-key variation; the done flag is checked per run
        # and a failed hint falls back to the full bound.
        hint = int(int(np.asarray(n_iter)) * 1.2) + cfg.max_depth + 2

        def run_grad(k):
            loss, grads, done = loss_and_grad_wavefront(
                params, scene_d, cam, cfg, k, target, packed_d,
                backend=backend, queue=queue, steps_hint=hint)
            if not bool(np.asarray(done)):  # hint too small: full bound
                print("# note: steps_hint insufficient; full-bound rerun",
                      file=sys.stderr)
                loss, grads = loss_and_grad_wavefront(
                    params, scene_d, cam, cfg, k, target, packed_d,
                    backend=backend, queue=queue)
            # Sync by fetching the loss + one grad scalar.
            return (float(np.asarray(loss)),
                    float(np.asarray(grads["albedo"]).ravel()[0]))

        t0 = time.time()
        run_grad(key)
        t_compile_run = time.time() - t0
        # Median of 3 timed runs (headline must be reproducible, not a
        # best-in-session observation).
        times = []
        for i in range(1, 4):
            t0 = time.time()
            loss, g0 = run_grad(jax.random.key(i))
            times.append(time.time() - t0)
        dt = sorted(times)[1]
        rays = n_closest + n_shadow
        out = {
            "metric": "grad_rays_per_s_per_chip",
            "value": round(rays / dt, 1),
            "unit": "rays/s (fwd segments / fwd+bwd seconds)",
            "detail": {
                "scene": scene_name, "tris": int(scene.n_tris),
                "size": size, "spp": spp, "queue": queue,
                "backend": backend, "loss": loss,
                "n_closest": int(n_closest), "n_shadow": int(n_shadow),
                "compile_plus_run_s": round(t_compile_run, 2),
                "run_s": round(dt, 3),
                "run_s_all": [round(t, 3) for t in times],
                **device_detail(),
            },
        }
        print(json.dumps(out))
        return

    _, d = timed_render(scene_d, cam, cfg, packed, scene, queue,
                        backend=backend)
    out = {
        "metric": "rays_per_s_per_chip",
        "value": round(d["rays_per_s"], 1),
        "unit": "rays/s",
        "detail": {
            "scene": scene_name,
            "tris": int(scene.n_tris),
            "size": size,
            "spp": spp,
            "max_depth": cfg.max_depth,
            "queue": queue,
            "backend": backend,
            "steps": int(n_steps(cfg, min(queue, cfg.n_pixels * cfg.spp))),
            "steps_run": d["steps_run"],
            "overflow": d["overflow"],
            "exact_retry": d["exact_retry"],
            "n_closest": d["n_closest"],
            "n_shadow": d["n_shadow"],
            "bvh_build_s": round(t_build, 2),
            "compile_plus_run_s": round(d["compile_plus_run_s"], 2),
            "run_s": round(d["run_s"], 3),
            "run_s_all": [round(t, 3) for t in d["run_s_all"]],
            "mean_radiance": round(d["mean_radiance"], 5),
            **device_detail(),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
