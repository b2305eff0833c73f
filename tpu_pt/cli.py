"""Command-line entry point.

Counterpart of the reference's ``src/main.cpp`` getopt interface
(SURVEY.md §2 row 17: ``./pathtracer -s spp -l light_samples -m max_depth
-r w h -f outfile scene.dae``), headless mode only — a live OpenGL editor is
out of scope for a batch renderer (SURVEY.md §7 step 8); progressive/BVH
introspection lives in ``tpu_pt dump-bvh`` and the checkpointing renderer.

Usage:
    python -m tpu_pt.cli render cornell-spheres -s 64 -m 4 -r 512 512 -f out.png
    python -m tpu_pt.cli render path/to/scene.dae -f out.png
    python -m tpu_pt.cli dump-bvh cornell-spheres
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load_scene(name: str):
    """Resolve a scene spec: builtin name or a .dae/.obj file path."""
    from tpu_pt.scene import cornell, meshes

    builtin = {
        "cornell": lambda: (cornell.cornell("empty"), cornell.camera),
        "cornell-empty": lambda: (cornell.cornell("empty"), cornell.camera),
        "cornell-spheres": lambda: (cornell.cornell("spheres"), cornell.camera),
        "cornell-glossy": lambda: (cornell.cornell("glossy"), cornell.camera),
        "cornell-mesh": lambda: (cornell.cornell("mesh"), cornell.camera),
        "big": lambda: (meshes.big_scene(subdiv=7), meshes.big_camera),
        "big-1m": lambda: (meshes.big_scene(subdiv=8), meshes.big_camera),
        "atrium": lambda: (meshes.atrium_scene(), meshes.atrium_camera),
    }
    if name in builtin:
        return builtin[name]()
    if name.endswith(".dae"):
        from tpu_pt.scene import collada

        return collada.load(name)
    if name.endswith(".obj"):
        from tpu_pt.scene import obj

        return obj.load(name)
    raise SystemExit(
        f"unknown scene {name!r}; builtins: {', '.join(sorted(builtin))}"
    )


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory.  Otherwise
    the cache lives in ``<checkout>/.jax_cache`` (listed in .gitignore): a
    fixed path, because the path is part of what a cache hit needs.
    Production-size renders take minutes to compile cold."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache


def gpu_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cmd_render(args) -> int:
    import jax

    enable_compile_cache()
    from tpu_pt.config import RenderConfig
    from tpu_pt.render import film

    scene, camera_fn = _load_scene(args.scene)
    if args.envmap:
        from tpu_pt.render.envmap import load_envmap
        from tpu_pt.scene.types import with_envmap

        scene = with_envmap(scene, load_envmap(args.envmap))
    cfg = RenderConfig(
        width=args.resolution[0], height=args.resolution[1], spp=args.spp,
        max_depth=args.max_depth, ns_area_light=args.light_samples,
        direct_only=args.direct_only,
    )
    cam = camera_fn(cfg.width, cfg.height)
    key = jax.random.key(args.seed)
    n_overflow = 0  # capacity-contract truncations (cluster backend)

    t0 = time.time()
    if args.backend == "brute":
        from tpu_pt.render.driver import render

        img = render(scene, cam, cfg, key, backend="brute")
    elif args.backend == "bvh":
        from tpu_pt.bvh.sah import build_bvh
        from tpu_pt.render.driver import render

        bvh = build_bvh(scene)
        img = render(scene, cam, cfg, key, backend="bvh", bvh=bvh)
    else:  # wavefront — the performance path
        import numpy as np

        from tpu_pt.render.wavefront import render_wavefront_counts

        host_scene = scene
        if args.backend == "cluster":
            if args.bvh == "lbvh":
                from tpu_pt.bvh.cluster import build_cluster_device

                scene = jax.device_put(scene)
                bvh = jax.jit(build_cluster_device)(scene)
            elif args.autotune:
                # Frontier caps + pair budget sized from the REAL wavefront
                # population (warmed mixed-depth probe runs across the
                # image) — the capacity recipe for scenes denser than the
                # grid-heuristic default (e.g. the atrium interior).
                from tpu_pt.bvh.cluster import autotune_for_render

                bvh = autotune_for_render(scene, cam, cfg, queue=args.queue,
                                          exact_fallback=False)
            else:
                from tpu_pt.bvh.cluster import build_cluster_bvh

                bvh = build_cluster_bvh(scene)
            wf_backend = "cluster"
        else:  # "wavefront"/"packed": octant skip-pointer traversal
            if args.bvh == "lbvh":
                from tpu_pt.bvh.lbvh import build_lbvh

                bvh = build_lbvh(scene)
            else:
                from tpu_pt.bvh.native import build_packed

                bvh = build_packed(scene)
            wf_backend = "packed"
        bvh = jax.device_put(bvh)
        scene = jax.device_put(scene)

        suspects = [None]  # per-pixel overflow flags of the counted render

        def _render_once(exact_bvh=False):
            if args.checkpoint:
                # Progressive, crash-resumable render: spp-chunked
                # accumulation checkpointed to npz after every chunk;
                # kill-and-resume produces the bit-exact one-shot image
                # (the reference's progressive display + 'D' buffer dump,
                # SURVEY.md §2 r16/§3.4, made headless + durable).
                from tpu_pt.render.progressive import render_progressive

                def on_chunk(spp_done, preview):
                    print(f"progress: {spp_done}/{cfg.spp} spp",
                          file=sys.stderr)
                    if args.preview:
                        film.save(args.preview, np.asarray(preview))

                img, novf = render_progressive(
                    scene, cam, cfg, key, bvh, checkpoint=args.checkpoint,
                    chunk_spp=args.chunk_spp, queue=args.queue,
                    backend=wf_backend, on_chunk=on_chunk,
                    return_counts=True,
                    # Abort on the first overflowing chunk (ADVICE r4):
                    # the fallback-attached retry resumes the checkpoint,
                    # so nothing rendered before the overflow is redone.
                    stop_on_overflow=(wf_backend == "cluster"
                                      and not args.no_exact_fallback),
                    overflow_is_exact=exact_bvh)
                return np.asarray(img), int(novf)
            if wf_backend == "cluster" and not args.no_exact_fallback \
                    and not exact_bvh:
                # Track per-pixel suspect flags so an overflow can be
                # repaired by re-rendering ONLY the flagged pixels.
                from tpu_pt.render.wavefront import \
                    render_wavefront_suspect_counts

                img, _, _, novf, _, sus = render_wavefront_suspect_counts(
                    scene, cam, cfg, key, bvh, queue=args.queue,
                    backend=wf_backend)
                suspects[0] = np.asarray(sus)
                return np.asarray(img), int(np.asarray(novf))
            img, _, _, novf, _ = render_wavefront_counts(
                scene, cam, cfg, key, bvh, queue=args.queue,
                backend=wf_backend)
            return np.asarray(img), int(np.asarray(novf))

        img, n_overflow = _render_once()
        if n_overflow and wf_backend == "cluster" \
                and not args.no_exact_fallback:
            # Verify-then-retry exactness: the counted render PROVED the
            # capacity contract broke, so re-render with the packed-walk
            # fallback attached (overflowed rays re-traced exactly).  The
            # fallback program compiles and runs slower, so it is only paid
            # when the fast program is actually wrong.
            from tpu_pt.bvh.cluster import attach_fallback

            print(f"note: {n_overflow} BVH candidates overflowed static "
                  "budgets; re-rendering with the exact fallback attached",
                  file=sys.stderr)
            # The progressive checkpoint is NOT deleted: with
            # stop_on_overflow the overflowing chunk was never written, so
            # the stored accumulator holds only exact chunks — and a
            # fallback-attached traversal is bit-identical on those, so the
            # retry RESUMES instead of redoing the finished spp (VERDICT r5
            # task 6: repair cost scales with the un-rendered remainder,
            # not the whole job).
            bvh = jax.device_put(attach_fallback(
                jax.tree.map(np.asarray, bvh), host_scene))
            if suspects[0] is not None and suspects[0].sum() > 0 \
                    and not args.checkpoint:
                # Suspect-pixel-only repair (VERDICT r5 task 6): the
                # counted render flagged exactly the pixels whose paths
                # overflowed; re-trace ONLY those through the exact BVH —
                # repair cost scales with the suspect count, not the
                # image size.
                from tpu_pt.render.wavefront import repair_suspect_pixels

                n_sus = int(suspects[0].sum())
                print(f"note: repairing {n_sus} suspect pixels "
                      f"({100.0 * n_sus / cfg.n_pixels:.2f}% of the image)",
                      file=sys.stderr)
                img, n_overflow = repair_suspect_pixels(
                    scene, cam, cfg, key, bvh, img, suspects[0],
                    queue=args.queue, backend=wf_backend)
                img = np.asarray(img)
            else:
                img, n_overflow = _render_once(exact_bvh=True)
            print(f"note: exact retry done ({n_overflow} overflows "
                  "re-traced; image is exact)", file=sys.stderr)
        elif n_overflow:
            print(f"WARNING: {n_overflow} BVH candidates truncated by the "
                  "capacity contract — the image may be missing hits; "
                  "re-run with --autotune (or drop --no-exact-fallback)",
                  file=sys.stderr)
    dt = time.time() - t0

    n_rays = cfg.n_pixels * cfg.spp  # primary rays (bounces extra)
    print(
        json.dumps(
            dict(
                scene=args.scene, width=cfg.width, height=cfg.height,
                spp=cfg.spp, max_depth=cfg.max_depth, seconds=round(dt, 3),
                primary_rays=n_rays,
                primary_rays_per_s=round(n_rays / dt, 1),
                mean_radiance=round(float(img.mean()), 5),
                overflow=n_overflow,
            )
        )
    )
    film.save(args.outfile, img)
    print(f"wrote {args.outfile}", file=sys.stderr)
    return 0


def cmd_visualize_bvh(args) -> int:
    """Render a BVH traversal-cost heatmap — headless replacement for the
    reference viewer's interactive 'V' BVH-visualize mode (SURVEY.md §3.4)."""
    import numpy as np

    from tpu_pt.bvh.native import build_packed
    from tpu_pt.render import debug, film

    scene, camera_fn = _load_scene(args.scene)
    packed = _load_scene_bvh(scene)
    cam = camera_fn(args.resolution[0], args.resolution[1])
    stats = debug.bvh_heatmap(packed, cam, args.resolution[0], args.resolution[1])
    print(json.dumps(dict(
        scene=args.scene,
        mean_visits=round(stats["mean_visits"], 2),
        max_visits=stats["max_visits"],
        mean_leaf_tests=round(stats["mean_leaf_tests"], 2),
    )))
    film.save(args.outfile, debug.heatmap_image(stats["visits"]), gamma=1.0)
    print(f"wrote {args.outfile}", file=sys.stderr)
    return 0


def _load_scene_bvh(scene):
    import jax

    from tpu_pt.bvh.native import build_packed

    return jax.device_put(build_packed(scene))


def cmd_dump_bvh(args) -> int:
    """BVH introspection dump — the headless replacement for the reference's
    interactive 'V' BVH-visualize mode (SURVEY.md §3.4, §5 tracing)."""
    import numpy as np

    from tpu_pt.bvh.sah import build_bvh

    scene, _ = _load_scene(args.scene)
    bvh = build_bvh(scene)
    n = int(bvh.node_min.shape[0])
    leaf = np.asarray(bvh.prim_count) > 0

    from tpu_pt.bvh.cluster import build_cluster_bvh

    cb = build_cluster_bvh(scene)
    print(json.dumps(dict(
        scene=args.scene, prims=scene.n_prims, nodes=n,
        leaves=int(leaf.sum()),
        max_leaf_size=int(np.asarray(bvh.prim_count).max()),
        root_min=np.asarray(bvh.node_min)[0].tolist(),
        root_max=np.asarray(bvh.node_max)[0].tolist(),
        cluster=dict(
            clusters=cb.n_clusters,
            pyramid_levels=[int(l.shape[0]) for l in cb.levels],
            frontier_caps=list(cb.frontiers),
            k_leaf=cb.k_leaf,
            pair_budget=cb.pair_budget,
            tile_bytes=int(np.asarray(cb.tiles).nbytes),
        ),
    )))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_pt")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="headless render to PNG")
    pr.add_argument("scene")
    pr.add_argument("-s", "--spp", type=int, default=16)
    pr.add_argument("-m", "--max-depth", type=int, default=4)
    pr.add_argument("-l", "--light-samples", type=int, default=1)
    pr.add_argument("-r", "--resolution", type=int, nargs=2, default=[512, 512])
    pr.add_argument("-f", "--outfile", default="out.png")
    pr.add_argument("-e", "--envmap", default=None,
                    help="lat-long environment map (.exr or .pfm)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--direct-only", action="store_true")
    pr.add_argument("--backend",
                    choices=["brute", "bvh", "wavefront", "cluster"],
                    default="cluster")
    pr.add_argument("--queue", type=int, default=1 << 13,
                    help="wavefront queue size (lanes)")
    pr.add_argument("--bvh", choices=["sah", "lbvh"], default="sah",
                    help="BVH build: host SAH (native/C++) or device LBVH")
    pr.add_argument("--autotune", action="store_true",
                    help="size cluster frontier caps + pair budget from "
                         "probe runs of the real wavefront (use for dense "
                         "interiors)")
    pr.add_argument("--checkpoint", default=None, metavar="STATE.npz",
                    help="progressive render: checkpoint the spp-chunked "
                         "accumulator here after every chunk and resume "
                         "from it if present (bit-exact vs one-shot)")
    pr.add_argument("--preview", default=None, metavar="PREVIEW.png",
                    help="with --checkpoint: (re)write the current mean "
                         "image here after every spp chunk")
    pr.add_argument("--chunk-spp", type=int, default=None,
                    help="spp per progressive chunk (default cfg.spp_chunk)")
    pr.add_argument("--no-exact-fallback", action="store_true",
                    help="skip the packed-BVH exact retrace of rays whose "
                         "candidates overflow static budgets (saves the "
                         "fallback build + HBM; overflow then drops hits)")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("dump-bvh", help="print BVH structure stats")
    pb.add_argument("scene")
    pb.set_defaults(fn=cmd_dump_bvh)

    pv = sub.add_parser("visualize-bvh",
                        help="render BVH traversal-cost heatmap PNG")
    pv.add_argument("scene")
    pv.add_argument("-r", "--resolution", type=int, nargs=2, default=[256, 256])
    pv.add_argument("-f", "--outfile", default="bvh_heatmap.png")
    pv.set_defaults(fn=cmd_visualize_bvh)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
