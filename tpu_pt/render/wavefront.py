"""Persistent-wavefront renderer — the performance path.

This is the heart of the design (SURVEY.md §2 "Parallelism strategies",
§5 "Long-context…the wavefront transform", §7 step 4).  The reference's
CUDA megakernel gives every pixel a thread that recurses through bounces,
paying warp divergence in the BVH walk (SURVEY.md §3.2).  Here the loop is
inverted: bounce depth becomes the OUTER loop over one global, fixed-size
ray queue.

Stream compaction with static shapes: classic GPU wavefront tracers shrink
the queue each bounce (sort + kernel launch on the live prefix).  XLA needs
static shapes, so instead of shrinking, the queue is kept **always full**:
every step, dead lanes are *refilled* with fresh camera samples from the
remaining sample budget, so lanes at different bounce depths coexist and
occupancy stays at 100% until the tail.  There is no idle lane for the
whole steady state — BASELINE.json's "wavefront (stream-compacted
megakernel-free) ray batches" rebuilt for XLA semantics.

Determinism: randomness is counter-based per (sample id, depth, purpose)
(core/sampling.py), so this renderer produces bit-identical radiance samples
to the unrolled oracle integrator regardless of lane scheduling — tested in
tests/test_wavefront.py.

The outer loop is a ``lax.scan`` with a statically-derived step bound, so
the whole renderer remains reverse-differentiable (the adjoint sweep runs
scan-backward; per-bounce gradient work is the "backward bounce sweep" of
BASELINE.json).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from tpu_pt.config import RenderConfig
from tpu_pt.core.camera import generate_rays, pixel_xy
from tpu_pt.core.sampling import draws_lane
from tpu_pt.core.vecmath import dot, make_coord_space, to_local, to_world
from tpu_pt.render import bsdf as bsdf_mod
from tpu_pt.render import lights as lights_mod
from tpu_pt.render.integrator import _BSDF, _LIGHT0, _RR, _STRIDE, DRAW_JITTER, shade_info
from tpu_pt.scene.types import Scene


# Default whole-step lane slicing for the fast renderer (see _step's
# step_slices; overridable per call / via BENCH_STEP_SLICES in bench.py).
STEP_SLICES = 1

# Unrolled wide-budget warm-up steps before the fast path's while_loop: the
# first waves' shadow batches are fully occupied and wide-angle coherent,
# so they run the WIDE any-hit pair budget; the loop body then compiles the
# narrow steady-state budget statically.  The autotuner's pair attribution
# mirrors this split (cluster.autotune_for_render).
WIDE_PREFIX_STEPS = 2


class QueueState(NamedTuple):
    """One lane per in-flight path segment."""

    ro: jnp.ndarray          # (Q, 3)
    rd: jnp.ndarray          # (Q, 3)
    beta: jnp.ndarray       # (Q, 3) path throughput
    ray_id: jnp.ndarray      # (Q,) logical sample id (pixel*spp + s); -1 idle
    depth: jnp.ndarray       # (Q,) current bounce depth
    include_le: jnp.ndarray  # (Q, 1) add emission at next hit
    alive: jnp.ndarray       # (Q, 1) lane carries a live path
    next_sample: jnp.ndarray  # () int32 — next unspawned sample id
    accum: jnp.ndarray       # (P, 3) radiance accumulator (sum over samples)
    suspect: jnp.ndarray     # (P,) i32 per-pixel suspect flags when
    #                          tracked (suspect-pixel repair); (1,) dummy
    #                          otherwise


def _respawn(cam, cfg: RenderConfig, key, st: QueueState, pix_lo, n_pix_local,
             spp_lo, spp_count, pix_stride: int = 1,
             pix_ids=None) -> QueueState:
    """Fill dead lanes with fresh camera samples from the remaining budget.

    The sample stream covers pixels {pix_lo + j*pix_stride : j <
    n_pix_local} × samples [spp_lo, spp_lo + spp_count); with pix_lo=0,
    pix_stride=1, n_pix_local=n_pixels, spp_lo=0, spp_count=cfg.spp this is
    the whole image.  Tile sharding (tpu_pt/dist) gives each chip its own
    pixel set — contiguous (stride 1) or round-robin INTERLEAVED (stride =
    #shards, the load-balance mitigation of SURVEY.md §2 r15's dynamic
    assignment) — and progressive/checkpointed rendering
    (render/progressive.py) its spp chunk; ray_ids — and therefore random
    numbers — are *globally* consistent either way: sharded/chunked renders
    sum to the one-shot image bit-for-bit.
    """
    total = jnp.int32(n_pix_local * spp_count)
    dead = ~st.alive[:, 0]
    rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
    cand = st.next_sample + rank
    spawn = dead & (cand < total)
    n_spawned = jnp.sum(spawn.astype(jnp.int32))

    # Global sample id keyed off the global pixel index (RNG consistency).
    pixel_local = cand // spp_count
    if pix_ids is not None:
        # Arbitrary pixel subset (suspect-pixel repair): pix_ids maps the
        # local accumulator row to the GLOBAL pixel.  ray_id stores the
        # LOCAL sample id (for O(1) accum addressing); every RNG draw uses
        # the translated global id (_global_ray_id), so each pixel's
        # radiance is bit-identical to its value in a full-image render.
        pixel = pix_ids[jnp.clip(jnp.where(spawn, pixel_local, 0), 0,
                                 pix_ids.shape[0] - 1)].astype(jnp.int32)
        new_id = jnp.where(
            spawn, pixel_local * cfg.spp + spp_lo + cand % spp_count,
            st.ray_id)
        gid = jnp.where(spawn, pixel * cfg.spp + spp_lo + cand % spp_count,
                        _global_ray_id(st.ray_id, cfg, pix_ids))
    else:
        pixel = (pix_lo + jnp.where(spawn, pixel_local, 0) * pix_stride
                 ).astype(jnp.int32)
        new_id = jnp.where(
            spawn, pixel * cfg.spp + spp_lo + cand % spp_count, st.ray_id
        )
        gid = new_id
    jitter = draws_lane(key, gid, jnp.zeros_like(gid) + DRAW_JITTER, 2)
    xy = pixel_xy(cfg.width, cfg.height, pixel, jax.lax.stop_gradient(jitter))
    ro_new, rd_new = generate_rays(cam, xy)

    spawn_c = spawn[:, None]
    return st._replace(
        ro=jnp.where(spawn_c, ro_new, st.ro),
        rd=jnp.where(spawn_c, rd_new, st.rd),
        beta=jnp.where(spawn_c, 1.0, st.beta),
        ray_id=new_id,
        depth=jnp.where(spawn, 0, st.depth),
        include_le=jnp.where(spawn_c, True, st.include_le),
        alive=st.alive | spawn_c,
        next_sample=st.next_sample + n_spawned,
    )


def _global_ray_id(ray_id, cfg: RenderConfig, pix_ids):
    """Local sample id -> global sample id under a pix_ids indirection
    (identity when pix_ids is None)."""
    if pix_ids is None:
        return ray_id
    rid = jnp.maximum(ray_id, 0)
    g = pix_ids[jnp.clip(rid // cfg.spp, 0, pix_ids.shape[0] - 1)].astype(
        jnp.int32) * cfg.spp + rid % cfg.spp
    return jnp.where(ray_id < 0, ray_id, g)


def _step(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn, occluded_fn,
          st: QueueState, pix_lo, n_pix_local, spp_lo, spp_count,
          ray_probe: list | None = None,
          pix_stride: int = 1, track_suspects: bool = False,
          pix_ids=None, shadow_narrow: bool = False,
          step_slices: int = 1) -> QueueState:
    """One wavefront iteration: respawn → intersect → shade/NEE → scatter.

    ray_probe: observability hook — when a list is passed, every traversal's
    actual ray batch is appended as (ro, rd, t_max (Q,1)); entry 0 is the
    closest-hit batch, the rest are the NEE shadow batches.  This is the
    REAL mixed-depth population the capacity autotuner must cover
    (cluster.autotune_for_render; VERDICT r3 task 1b).

    step_slices > 1 runs the post-respawn body as that many independent
    strided lane slices, so slice i+1's closest traversal is independent
    of slice i's shadow test and XLA can interleave their latency gaps —
    the whole-step extension of the intra-traversal split.  Per-lane math
    is unchanged; only the pair-budget slicing (counted) and, at spp>1,
    the per-pixel float add order across slices can differ."""
    st = _respawn(cam, cfg, key, st, pix_lo, n_pix_local, spp_lo, spp_count,
                  pix_stride, pix_ids=pix_ids)
    Q = st.ro.shape[0]
    k = step_slices
    while k > 1 and (Q % k != 0 or Q // k < 2048):
        k //= 2
    if k > 1:
        lanes = (st.ro, st.rd, st.beta, st.ray_id, st.depth, st.include_le,
                 st.alive)
        outs = [
            _step_slice(scene, cam, cfg, key, intersect_fn, occluded_fn,
                        tuple(x[i::k] for x in lanes), pix_lo, n_pix_local,
                        spp_lo, ray_probe, pix_stride, track_suspects,
                        pix_ids, shadow_narrow)
            for i in range(k)
        ]

        def merge(vals):
            v = jnp.stack(vals, 1)
            return v.reshape(Q, *vals[0].shape[1:])

        (contribs, pixels, conts, ros, rds, betas, incs, suss,
         ncs, nss, novfs) = zip(*outs)
        contrib, pixel, cont = merge(contribs), merge(pixels), merge(conts)
        ro_n, rd_n, beta_n, inc_n = (merge(ros), merge(rds), merge(betas),
                                     merge(incs))
        sus_lane = merge(suss) if track_suspects else None
        counts = (sum(ncs), sum(nss), sum(novfs))
    else:
        (contrib, pixel, cont, ro_n, rd_n, beta_n, inc_n, sus_lane,
         nc, ns_, novf) = _step_slice(
            scene, cam, cfg, key, intersect_fn, occluded_fn,
            (st.ro, st.rd, st.beta, st.ray_id, st.depth, st.include_le,
             st.alive), pix_lo, n_pix_local, spp_lo, ray_probe, pix_stride,
            track_suspects, pix_ids, shadow_narrow)
        counts = (nc, ns_, novf)

    if track_suspects:
        sus_px = st.suspect.at[pixel].max(sus_lane, mode="drop")
    if cfg.spp == 1:
        # spp=1: in-flight ray ids are unique and ray_id == pixel, so live
        # lanes scatter to DISTINCT pixels; dead lanes are remapped to
        # distinct out-of-bounds slots (dropped).  unique_indices lets XLA
        # skip the sort-based duplicate-combining scatter expansion —
        # bit-identical result (exactly one add per pixel either way).
        lane = jnp.arange(Q, dtype=jnp.int32)
        pixel_u = jnp.where(st.alive[:, 0], pixel, n_pix_local + lane)
        accum = st.accum.at[pixel_u].add(
            jnp.where(st.alive, contrib, 0.0), mode="drop",
            unique_indices=True)
    else:
        accum = st.accum.at[pixel].add(
            jnp.where(st.alive, contrib, 0.0), mode="drop"
        )
    st = st._replace(
        ro=jnp.where(cont, ro_n, st.ro),
        rd=jnp.where(cont, rd_n, st.rd),
        beta=jnp.where(cont, beta_n, st.beta),
        depth=st.depth + 1,
        include_le=jnp.where(cont, inc_n, st.include_le),
        alive=cont,
        accum=accum,
        suspect=sus_px if track_suspects else st.suspect,
    )
    return st, counts


def _step_slice(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn,
                occluded_fn, lanes, pix_lo, n_pix_local, spp_lo,
                ray_probe, pix_stride, track_suspects, pix_ids,
                shadow_narrow):
    """Post-respawn step body for one lane slice.  Returns per-lane
    (contrib, pixel, cont, ro_next, rd_next, beta_next, include_le_next,
    suspect_lane, n_closest, n_shadow, n_ovf)."""
    ro0, rd0, beta0, ray_id, depth, include_le, alive0 = lanes
    Q = ro0.shape[0]
    rid_g = _global_ray_id(ray_id, cfg, pix_ids)  # RNG identity
    n_closest = jnp.sum(alive0[:, 0].astype(jnp.int32))  # rays traced now
    base = 1 + depth * _STRIDE  # (Q,) per-lane draw base

    t_min = jnp.zeros((Q, 1), jnp.float32)
    # Dead lanes get t_max < t_min: every backend reports a trivial miss
    # AND the pair-major cluster walk spawns no candidate pairs for them
    # (budget + work proportional to LIVE lanes only).
    t_max = jnp.where(alive0, 1e30, -1.0)
    # Traversal is DETACHED on both sides: every intersect output is already
    # stop_gradient'ed downstream (shade_info detaches t/u/v; hit/prim are
    # bool/int), so detaching the ray inputs changes no gradient value — but
    # it stops jax.linearize from staging tangent residuals for the whole
    # BVH walk inside every remat chunk of the differentiable scan (once
    # the dominant cost of the backward pass).
    sg = jax.lax.stop_gradient
    if ray_probe is not None:
        ray_probe.append((ro0, rd0, t_max))
    if track_suspects:
        hit, n_ovf, sus_c = intersect_fn(sg(scene), sg(ro0), sg(rd0),
                                         t_min, t_max)
    else:
        hit, n_ovf = intersect_fn(sg(scene), sg(ro0), sg(rd0), t_min,
                                  t_max)
    # Name the traversal outputs as checkpoint residuals: under the
    # save_only_these_names policy (wavefront_accum), the remat replay of a
    # chunk's backward reads the SAVED (Q,)-sized hit records instead of
    # re-running the whole BVH descent — the two traversals are ~90% of
    # step cost and fully detached, so replaying them was pure waste
    # (VERDICT r4 weak #3).  O(steps·Q) extra residual bytes, small next
    # to the accumulator carries.
    hit = jax.tree.map(lambda x: checkpoint_name(x, "isect"), hit)
    n_ovf = checkpoint_name(n_ovf, "isect")
    if cfg.debug_checks:
        # Sanitizer (SURVEY.md §5; VERDICT r3 task 6): invariant checks on
        # the traversal contract, compiled in only when the static config
        # flag is set.  Surfaced by checkify wrappers
        # (render_wavefront_checked) — zero cost otherwise.
        from jax.experimental import checkify

        ht = hit.t[:, 0]
        hh = hit.hit[:, 0]
        checkify.check(
            jnp.all(jnp.where(hh, (ht > 0.0) & jnp.isfinite(ht), True)),
            "traversal: hit.t must be positive finite where hit")
        checkify.check(
            jnp.all(jnp.where(hh, ht <= t_max[:, 0], True)),
            "traversal: hit.t beyond t_max")
        uv = hit.u[:, 0] + hit.v[:, 0]
        checkify.check(
            jnp.all(jnp.where(hh, (hit.u[:, 0] >= -1e-4)
                              & (hit.v[:, 0] >= -1e-4) & (uv <= 1 + 1e-4),
                              True)),
            "traversal: barycentrics outside the triangle")
        checkify.check(jnp.all(jnp.isfinite(beta0)),
                       "wavefront: non-finite path throughput")
    si = shade_info(scene, ro0, rd0, hit)
    wo_world = -rd0
    tb, bb = make_coord_space(si.ns)
    wo = to_local(wo_world, tb, bb, si.ns)
    # Local accum index (dead lanes may land anywhere: they add 0.0).
    if pix_ids is not None:
        pixel = jnp.maximum(ray_id, 0) // cfg.spp  # ray_id is LOCAL
    else:
        pixel = (jnp.maximum(ray_id, 0) // cfg.spp - pix_lo) // pix_stride
    sus_lane = None
    if track_suspects:
        # Per-lane suspect: this lane's path overflowed a static budget in
        # ANY of this step's traversals.  Dead lanes are never suspect
        # (t_max < 0 spawns no candidates).
        sus_lane = (sus_c & alive0[:, 0]).astype(jnp.int32)

    contrib = jnp.zeros((Q, 3), jnp.float32)
    # Miss → environment radiance (same semantics as the oracle integrator).
    from tpu_pt.render.envmap import eval_env

    contrib = contrib + jnp.where(
        alive0 & ~hit.hit & include_le,
        beta0 * eval_env(scene.env_map, rd0), 0.0,
    )
    alive = alive0 & hit.hit
    # Emission at hit (one-sided).
    front = dot(wo_world, si.ns) > 0.0
    contrib = contrib + jnp.where(
        alive & include_le & front, beta0 * si.mat.emission, 0.0
    )

    # ---- Next-event estimation. ----
    delta_b = bsdf_mod.is_delta(si.mat)
    # Useful shadow rays this step (non-delta live hits × lights × samples).
    n_shadow = jnp.sum((alive & ~delta_b)[:, 0].astype(jnp.int32)) * (
        scene.lights.count * cfg.ns_area_light
    )
    ns = cfg.ns_area_light
    for li in range(scene.lights.count):
        for s in range(ns):
            u = draws_lane(key, rid_g, base + _LIGHT0 + li * ns + s, 2)
            ls = lights_mod.sample_light(
                scene.lights, li, si.p, u, env_map=scene.env_map,
                env_tables=(scene.env_marg_cdf, scene.env_cond_cdf))
            wi_l = to_local(ls.wi, tb, bb, si.ns)
            f = bsdf_mod.eval_f(si.mat, wo, wi_l)
            cos_s = jnp.maximum(wi_l[..., 2:3], 0.0)
            mask = (
                alive & ~delta_b & (cos_s > 0.0)
                & (jnp.max(f * ls.radiance, axis=-1, keepdims=True) > 0.0)
            )
            shadow_o = si.p + si.ng * jnp.where(
                dot(ls.wi, si.ng) > 0.0, cfg.eps, -cfg.eps
            )
            # Masked lanes get a negative range: trivial miss, no pair work.
            # Detached for the same reason as the closest-hit traversal: the
            # occlusion bit is boolean, so no gradient ever flows through it.
            sh_tmax = jnp.where(mask, ls.dist * (1.0 - 1e-3), -1.0)
            if ray_probe is not None:
                ray_probe.append((shadow_o, ls.wi, sh_tmax))
            if track_suspects:
                occ, ovf_s, sus_s = occluded_fn(
                    sg(scene), sg(shadow_o), sg(ls.wi), sg(sh_tmax),
                    narrow=shadow_narrow)
                sus_lane = jnp.maximum(
                    sus_lane, (sus_s & mask[:, 0]).astype(jnp.int32))
            else:
                occ, ovf_s = occluded_fn(
                    sg(scene), sg(shadow_o), sg(ls.wi), sg(sh_tmax),
                    narrow=shadow_narrow)
            occ = checkpoint_name(occ, "isect")
            n_ovf = n_ovf + checkpoint_name(ovf_s, "isect")
            w = f * ls.radiance * cos_s / (ls.pdf * ns)
            contrib = contrib + jnp.where(mask & ~occ, beta0 * w, 0.0)

    if cfg.debug_checks:
        from jax.experimental import checkify

        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(alive0, contrib, 0.0))),
            "shading: non-finite radiance contribution")

    # ---- Scatter to next bounce. ----
    max_depth = 0 if cfg.direct_only else cfg.max_depth
    u3 = draws_lane(key, rid_g, base + _BSDF, 3)
    bs = bsdf_mod.sample(si.mat, wo, jax.lax.stop_gradient(u3))
    wi_world = to_world(jax.lax.stop_gradient(bs.wi), tb, bb, si.ns)
    cont = alive & bs.valid & (depth < max_depth)[:, None]
    beta = beta0 * jnp.where(cont, bs.weight, 1.0)
    # Russian roulette on the segment about to be traced.
    do_rr = (depth + 1 >= cfg.rr_start)[:, None]
    u_rr = draws_lane(key, rid_g, base + _RR, 1)
    rr_kill = do_rr & (u_rr >= cfg.rr_prob)
    beta = jnp.where(cont & do_rr, beta / cfg.rr_prob, beta)
    cont = cont & ~rr_kill

    ro_next = si.p + si.ng * jnp.where(dot(wi_world, si.ng) > 0.0, cfg.eps,
                                       -cfg.eps)
    return (contrib, pixel, cont, ro_next, wi_world, beta, bs.delta,
            sus_lane, n_closest, n_shadow, n_ovf)


def init_queue(Q: int, n_pix_local: int,
               track_suspects: bool = False) -> QueueState:
    """Fresh all-dead queue + zero accumulator (the scan/while carry)."""
    return QueueState(
        ro=jnp.zeros((Q, 3), jnp.float32),
        rd=jnp.concatenate([jnp.zeros((Q, 2)), jnp.ones((Q, 1))], -1),
        beta=jnp.zeros((Q, 3), jnp.float32),
        ray_id=jnp.full((Q,), -1, jnp.int32),
        depth=jnp.zeros((Q,), jnp.int32),
        include_le=jnp.zeros((Q, 1), bool),
        alive=jnp.zeros((Q, 1), bool),
        next_sample=jnp.int32(0),
        accum=jnp.zeros((n_pix_local, 3), jnp.float32),
        suspect=jnp.zeros((n_pix_local if track_suspects else 1,),
                          jnp.int32),
    )


def n_steps(cfg: RenderConfig, queue: int, n_pix: int = 0,
            spp_count: int = 0) -> int:
    """Static upper bound on wavefront iterations: every step consumes Q
    path segments while the budget lasts, plus a drain tail of max path
    length."""
    n_pix = n_pix or cfg.n_pixels
    spp_count = spp_count or cfg.spp
    depth = 1 if cfg.direct_only else cfg.max_depth + 1
    total_segments = n_pix * spp_count * depth
    return -(-total_segments // queue) + depth


def wavefront_accum(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                    queue: int, backend: str, pix_lo, n_pix_local: int,
                    spp_lo=0, spp_count: int = 0, with_counts: bool = False,
                    fast: bool = False, psum_axis: str | None = None,
                    pix_stride: int = 1, steps_hint: int | None = None,
                    with_done: bool = False, with_suspects: bool = False,
                    pix_ids=None, step_slices: int | None = None):
    """Render pixels {pix_lo + j*pix_stride : j < n_pix_local} × samples
    [spp_lo, spp_lo+spp_count) -> (n_pix_local, 3) radiance sums (divide by
    cfg.spp for the full-spp mean).  pix_lo/spp_lo may be traced.

    psum_axis: when set (inside shard_map with that axis name), the scene
    cotangent of EVERY remat chunk is psum'd inside that chunk's backward —
    the collective is issued while earlier chunks' backward kernels still
    run, which is the "grad allreduce overlapped with the backward bounce
    sweep" of BASELINE.json config 5.  The caller must then NOT tail-psum
    the parameter grads again."""
    from tpu_pt.render.driver import (_intersectors_counted,
                                      _intersectors_suspect)

    if step_slices is None:
        step_slices = STEP_SLICES
    spp_count = spp_count or cfg.spp
    if with_suspects:
        intersect_fn, occluded_fn = _intersectors_suspect(backend, bvh)
    else:
        intersect_fn, occluded_fn = _intersectors_counted(backend, bvh)
    Q = min(queue, n_pix_local * spp_count)
    st = init_queue(Q, n_pix_local, track_suspects=with_suspects)
    steps = n_steps(cfg, Q, n_pix_local, spp_count)
    if steps_hint is not None:
        # Tighter STATIC bound for the differentiable scan (VERDICT r3
        # task 5: the worst-case bound assumes every path survives to max
        # depth; RR + misses kill ~2/3, measured 459/1285 executed on the
        # headline).  The hint is a static compile key supplied by the
        # caller (e.g. the measured executed-step count of a counting run,
        # plus slack); pass with_done=True and CHECK the returned flag —
        # an insufficient hint silently drops samples otherwise.
        steps = max(1, min(steps, int(steps_hint)))
    pix_lo = jnp.int32(pix_lo)
    spp_lo = jnp.int32(spp_lo)

    if fast:
        # Forward-only path: while_loop exits as soon as the sample budget
        # is spent AND every lane is dead — the static `steps` bound pays
        # for its worst case only when actually needed (at small queues the
        # tail after budget exhaustion is most of the bound).  Not
        # reverse-differentiable; the diff/dist paths use the scan below.
        total = jnp.int32(n_pix_local * spp_count)

        # Wide warm-up PREFIX before the main loop: the first waves'
        # shadow batches are fully occupied and wide-angle coherent — the
        # binding any-hit pair population (884 step-0 truncations at 128²
        # under the steady-state budget).  The prefix steps run the wide
        # any-hit budget in a loop of their own; the main loop body then
        # compiles the NARROW one (pair_mults[3], ~2/3 the width)
        # statically — a runtime two-width lax.cond ladder would pay for
        # both branches.
        prefix = min(WIDE_PREFIX_STEPS, steps)

        def prefix_body(_, carry):
            st, nc, ns, novf = carry
            st, (c, s, o) = _step(scene, cam, cfg, key, intersect_fn,
                                  occluded_fn, st, pix_lo, n_pix_local,
                                  spp_lo, spp_count, pix_stride=pix_stride,
                                  track_suspects=with_suspects,
                                  pix_ids=pix_ids, shadow_narrow=False,
                                  step_slices=step_slices)
            return st, nc + c, ns + s, novf + o

        zero = jnp.int32(0)
        st, nc, ns, novf = jax.lax.fori_loop(0, prefix, prefix_body,
                                             (st, zero, zero, zero))

        def cond(carry):
            st, nc, ns, novf, i = carry
            return (i < steps) & (
                jnp.any(st.alive) | (st.next_sample < total))

        def wbody(carry):
            st, nc, ns, novf, i = carry
            st, (c, s, o) = _step(scene, cam, cfg, key, intersect_fn,
                                  occluded_fn, st, pix_lo, n_pix_local,
                                  spp_lo, spp_count, pix_stride=pix_stride,
                                  track_suspects=with_suspects,
                                  pix_ids=pix_ids,
                                  # direct-only renders: EVERY wave is a
                                  # fresh fully-occupied primary wave, so
                                  # the steady-state budget never applies.
                                  shadow_narrow=not cfg.direct_only,
                                  step_slices=step_slices)
            return st, nc + c, ns + s, novf + o, i + 1

        st, nc, ns, novf, n_iter = jax.lax.while_loop(
            cond, wbody, (st, nc, ns, novf, jnp.int32(prefix)))
        ret = (st.accum, (nc, ns, novf, n_iter)) if with_counts \
            else st.accum
        if with_suspects:
            ret = (*(ret if with_counts else (ret,)), st.suspect)
        if with_done:
            done = ~jnp.any(st.alive) & (st.next_sample >= total)
            return ret, done
        return ret

    def body(st, _):
        return _step(scene, cam, cfg, key, intersect_fn, occluded_fn, st,
                     pix_lo, n_pix_local, spp_lo, spp_count,
                     pix_stride=pix_stride,
                     track_suspects=with_suspects, pix_ids=pix_ids)

    # Differentiable path: √steps-chunked scan with rematerialization.  A
    # flat scan's adjoint stores EVERY carry (steps × (queue state + accum)
    # — O(steps·Q) residuals, which is what kept r1's differentiable
    # renders at toy sizes).  Chunking the scan and jax.checkpoint-ing each
    # chunk keeps only chunk-boundary carries + one chunk's internals:
    # O((steps/k + k)·Q) with k ≈ √steps.  Trailing steps beyond the budget
    # bound are no-ops (nothing left to respawn, every lane dead), so
    # padding steps to outer×inner changes nothing but wasted tail work.
    if steps > 16 or psum_axis is not None:
        inner = max(1, int(round(steps ** 0.5)))
        outer = -(-steps // inner)

        # Traversal-free backward (VERDICT r4 weak #3 / r5 task 2): save
        # the named "isect" traversal outputs as residuals so each chunk's
        # remat replay skips the two BVH descents entirely — they are
        # detached (stop_gradient on every input, records-only outputs), so
        # the adjoint needs only the (Q,)-sized hit/occlusion records.
        # Memory: O(steps · Q · ~8 words), small next to the per-chunk
        # accumulator carries the scan already stores.
        @functools.partial(
            jax.checkpoint,
            policy=jax.checkpoint_policies.save_only_these_names("isect"))
        def chunk_fn(scene, st):
            def body_c(st, _):
                return _step(scene, cam, cfg, key, intersect_fn,
                             occluded_fn, st, pix_lo, n_pix_local, spp_lo,
                             spp_count, pix_stride=pix_stride,
                             track_suspects=with_suspects, pix_ids=pix_ids)

            return jax.lax.scan(body_c, st, None, length=inner)

        if psum_axis is not None:
            axis = psum_axis

            @jax.custom_vjp
            def chunk_call(scene, st):
                return chunk_fn(scene, st)

            def chunk_fwd(scene, st):
                out, vjp = jax.vjp(chunk_fn, scene, st)
                return out, vjp

            def chunk_bwd(vjp, ct):
                g_scene, g_st = vjp(ct)
                # Reduce this chunk's parameter grads NOW, inside the
                # backward sweep: the collective runs while the next
                # (earlier) chunk's backward kernels run.  Sum over chunks
                # of per-chunk psums == tail psum of the sum (linearity).
                g_scene = jax.tree.map(
                    lambda g: g if g.dtype == jax.dtypes.float0
                    else jax.lax.psum(g, axis), g_scene)
                return g_scene, g_st

            chunk_call.defvjp(chunk_fwd, chunk_bwd)
        else:
            chunk_call = chunk_fn

        st, counts = jax.lax.scan(
            lambda st, _: chunk_call(scene, st), st, None, length=outer)
        counts = jax.tree.map(lambda c: c.reshape(-1), counts)
    else:
        st, counts = jax.lax.scan(body, st, None, length=steps)
    ret = (st.accum, counts) if with_counts else st.accum
    if with_suspects:
        ret = (*(ret if with_counts else (ret,)), st.suspect)
    if with_done:
        done = ~jnp.any(st.alive) & (
            st.next_sample >= jnp.int32(n_pix_local * spp_count))
        return ret, done
    return ret


@functools.partial(jax.jit,
                   static_argnames=("cfg", "queue", "backend", "fast"))
def render_wavefront(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                     queue: int = 1 << 17, backend: str = "bvh",
                     fast: bool = True):
    """Full-image render -> (H, W, 3) linear radiance.

    fast=True uses an early-exit while_loop (NOT reverse-differentiable);
    pass fast=False to differentiate through the render (fixed-length scan,
    pays the full worst-case step bound)."""
    accum = wavefront_accum(scene, cam, cfg, key, bvh, queue, backend,
                            0, cfg.n_pixels, fast=fast)
    img = accum / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3)


def render_wavefront_checked(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                             queue: int = 1 << 17, backend: str = "bvh"):
    """Sanitizer render (SURVEY.md §5 "race detection / sanitizers"): runs
    the wavefront with ``cfg.debug_checks`` forced on under
    ``checkify.checkify`` and RAISES on the first violated invariant
    (non-finite throughput/radiance, negative or out-of-range hit t, bad
    barycentrics).  The functional-core analogue of the reference's
    debug-build asserts — compiled checks, usable on the GPU.  Uses the
    scan path (checkify's control-flow support is complete there)."""
    from jax.experimental import checkify

    cfg = cfg.replace(debug_checks=True)

    @functools.partial(jax.jit, static_argnames=("cfg", "queue", "backend"))
    def run(scene, cam, cfg, key, bvh, queue, backend):
        def fn(scene, cam, key, bvh):
            # Input sanitation FIRST: NaN geometry silently masks into
            # misses downstream (every NaN comparison is False), so it is
            # undetectable from outputs.
            for name, arr in (("vertices", scene.vertices),
                              ("normals", scene.normals),
                              ("sph_center", scene.sph_center),
                              ("sph_radius", scene.sph_radius)):
                checkify.check(jnp.all(jnp.isfinite(arr)),
                               f"scene.{name} has non-finite values")
            accum = wavefront_accum(scene, cam, cfg, key, bvh, queue,
                                    backend, 0, cfg.n_pixels, fast=False)
            return (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)

        return checkify.checkify(fn, errors=checkify.user_checks)(
            scene, cam, key, bvh)

    err, img = run(scene, cam, cfg, key, bvh, queue, backend)
    err.throw()
    return img


@functools.partial(jax.jit, static_argnames=("cfg", "queue", "backend"))
def render_wavefront_counts(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                            queue: int = 1 << 17, backend: str = "bvh"):
    """Full-image render + honest ray accounting.

    Returns (image, n_closest, n_shadow, n_overflow, n_steps_run): the
    image plus the MEASURED number of useful closest-hit path segments and
    NEE shadow rays traced (per-step counts summed on device) — the
    accounting bench.py reports as rays/s — the summed capacity-contract
    overflow (candidates truncated by static budgets; nonzero means the
    render may have dropped hits and the BVH needs --autotune or larger
    caps), and the number of while_loop iterations actually executed (vs
    the static n_steps bound).
    """
    accum, (nc, ns, novf, n_iter) = wavefront_accum(
        scene, cam, cfg, key, bvh, queue, backend, 0, cfg.n_pixels,
        with_counts=True, fast=True)
    img = (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return (img, nc.astype(jnp.float32), ns.astype(jnp.float32), novf,
            n_iter)


@functools.partial(jax.jit, static_argnames=("cfg", "queue", "backend"))
def render_wavefront_suspect_counts(scene: Scene, cam, cfg: RenderConfig,
                                    key, bvh, queue: int = 1 << 17,
                                    backend: str = "bvh"):
    """render_wavefront_counts + a per-pixel SUSPECT flag image: pixel p is
    flagged iff any traversal of any of its path segments overflowed a
    static capacity budget, i.e. exactly the pixels a fallback-attached
    re-render could change.  Input of repair_suspect_pixels."""
    (accum, (nc, ns, novf, n_iter), sus) = wavefront_accum(
        scene, cam, cfg, key, bvh, queue, backend, 0, cfg.n_pixels,
        with_counts=True, fast=True, with_suspects=True)
    img = (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return (img, nc.astype(jnp.float32), ns.astype(jnp.float32), novf,
            n_iter, sus)


def repair_suspect_pixels(scene: Scene, cam, cfg: RenderConfig, key,
                          bvh_exact, img, suspect_flags, queue: int = 1 << 17,
                          backend: str = "cluster"):
    """Re-render ONLY the suspect pixels with an exact BVH (fallback
    attached) and splice them into ``img`` (H, W, 3) -> repaired image.

    Cost scales with the suspect count, not the image size (VERDICT r4
    weak #8): the pixel subset renders through the normal wavefront with a
    ``pix_ids`` indirection; counter-based RNG keyed by GLOBAL (pixel,
    sample, bounce) makes each repaired pixel bit-identical to its value
    in a full-image exact render.  The subset is padded to the next power
    of two (so repeat repairs share compile cache entries); padding
    duplicates the first suspect — its duplicate rows land in distinct
    local accumulator slots and are discarded on splice."""
    import numpy as np

    sus = np.flatnonzero(np.asarray(suspect_flags))
    if len(sus) == 0:
        return img, 0
    n = 1 << max(4, (len(sus) - 1).bit_length())
    ids = np.full((n,), sus[0], np.int32)
    ids[: len(sus)] = sus

    @functools.partial(jax.jit, static_argnames=("cfg", "queue", "backend",
                                                 "n_pix"))
    def run(scene, cam, cfg, key, bvh, ids, queue, backend, n_pix):
        accum, (nc, ns, novf, n_iter) = wavefront_accum(
            scene, cam, cfg, key, bvh, queue, backend, 0, n_pix,
            with_counts=True, fast=True, pix_ids=ids)
        return accum / cfg.spp, novf

    sub, novf = run(scene, cam, cfg, key, bvh_exact, jnp.asarray(ids),
                    min(queue, n * cfg.spp), backend, n)
    out = np.asarray(img).reshape(-1, 3).copy()
    out[sus] = np.asarray(sub)[: len(sus)]
    return out.reshape(cfg.height, cfg.width, 3), int(np.asarray(novf))
