"""Counter-based RNG + Monte-Carlo samplers.

Replaces the reference's ``Sampler2D/3D`` + ``random_uniform()``
(SURVEY.md §2 row 11: ``UniformGridSampler2D``,
``CosineWeightedHemisphereSampler3D``).

Key design point: randomness is **counter-based and
order-invariant**.  Every draw is a pure function of
``(base_key, ray_id, draw_id)`` where ray_id identifies the logical sample
(pixel*spp + s) and draw_id identifies the call site (bounce*stride +
purpose).  Consequently the oracle renderer, the BVH renderer, the wavefront
renderer (which *reorders* rays by compaction) and the sharded renderer all
consume bit-identical random numbers — which is what makes the
"image allclose vs CPU oracle" gates in BASELINE.json testable at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _mix(x):
    """murmur3 finalizer — full-avalanche 32-bit mixer (vector uint32)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _key_words(key):
    """PRNG key -> two uint32 words (stable per key)."""
    kd = jax.random.key_data(key).reshape(-1).astype(jnp.uint32)
    return kd[0], kd[-1]


def _hash_uniforms(key, ray_ids, draw_ids, n: int):
    """Stateless counter RNG: uniforms[r, i] = f(key, ray_ids[r], draw_ids[r], i).

    Pure vector integer ops (three murmur3 finalizer rounds) — no per-lane
    vmapped threefry, which dominated wavefront shading cost.  Quality is
    ample for Monte-Carlo rendering (full avalanche per round)."""
    k0, k1 = _key_words(key)
    r = ray_ids.astype(jnp.uint32)[:, None]
    d = draw_ids.astype(jnp.uint32)[:, None]
    i = jnp.arange(n, dtype=jnp.uint32)[None, :]
    h = _mix(d ^ k1 ^ (i * jnp.uint32(0x9E3779B9)))
    h = _mix(r ^ h ^ k0)
    h = _mix(h + i)
    # 24 high-entropy bits -> [0, 1) float32.
    return (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def draws(key, ray_ids, draw_id: int, n: int):
    """n uniforms in [0,1) per ray: shape (R, n).

    key: jax PRNG key.  ray_ids: (R,) int32 logical sample ids.
    draw_id: static int identifying the call site.  Counter-based and
    order-invariant: the value depends only on (key, ray_id, draw_id, i).
    """
    return _hash_uniforms(key, ray_ids, jnp.full_like(ray_ids, draw_id), n)


def draws_lane(key, ray_ids, draw_ids, n: int):
    """Like :func:`draws` but with a PER-LANE draw id (traced int32 array).

    Used by the persistent wavefront renderer where lanes sit at different
    bounce depths: ``draws_lane(key, ids, 1 + depth*64 + off, n)`` produces
    bit-identical values to ``draws(key, ids, 1 + d*64 + off, n)`` for a lane
    at depth d — which is what keeps wavefront output equal to the oracle's.
    """
    return _hash_uniforms(key, ray_ids, draw_ids, n)


def cosine_hemisphere(u):
    """Cosine-weighted hemisphere sample in the local frame (z = normal).

    u: (..., 2) uniforms.  Returns (dir, pdf): dir (..., 3), pdf (..., 1).
    pdf = cos(theta)/pi.
    """
    phi = 2.0 * jnp.pi * u[..., 0:1]
    cos_t = jnp.sqrt(jnp.maximum(1.0 - u[..., 1:2], 0.0))
    sin_t = jnp.sqrt(jnp.maximum(u[..., 1:2], 0.0))
    d = jnp.concatenate([jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1)
    pdf = cos_t / jnp.pi
    return d, pdf


def uniform_hemisphere(u):
    """Uniform hemisphere sample in the local frame.  pdf = 1/(2*pi)."""
    z = u[..., 0:1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * jnp.pi * u[..., 1:2]
    d = jnp.concatenate([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    pdf = jnp.full_like(z, 1.0 / (2.0 * jnp.pi))
    return d, pdf


def uniform_sphere(u):
    """Uniform sphere sample.  pdf = 1/(4*pi)."""
    z = 1.0 - 2.0 * u[..., 0:1]
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * jnp.pi * u[..., 1:2]
    d = jnp.concatenate([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    pdf = jnp.full_like(z, 1.0 / (4.0 * jnp.pi))
    return d, pdf
