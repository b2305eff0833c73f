"""Pinhole camera.

Counterpart of the reference's ``src/camera.*`` (SURVEY.md §2 row 12:
``Camera::generate_ray(double x, double y)`` with hFov/vFov and a
camera-to-world matrix).  Here ray generation is one fused batched op over
all pixels × samples — the "ray generation" stage of the wavefront pipeline.

Convention (matches the CMU462 family): camera looks down its **-z** axis;
x right, y up; (x, y) are normalized screen coordinates in [0,1]² with
(0,0) the bottom-left corner; fov stored in degrees.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.core.vecmath import normalize


class Camera(NamedTuple):
    """Pytree camera: c2w rotation (3,3), position (3,), fov in degrees."""

    c2w: jnp.ndarray      # (3, 3) camera-to-world rotation (columns = x,y,z axes)
    origin: jnp.ndarray   # (3,)
    hfov: jnp.ndarray     # () degrees
    vfov: jnp.ndarray     # () degrees

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), hfov=50.0, vfov=None, aspect=None):
        """Build a camera from eye/target/up.  If vfov is None it is derived
        from hfov and aspect (w/h), matching the reference's per-resolution
        fov handling."""
        eye = np.asarray(eye, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)
        z = eye - target
        z = z / np.linalg.norm(z)            # camera looks down -z
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.stack([x, y, z], axis=1)
        if vfov is None:
            if aspect is None:
                vfov = hfov
            else:
                vfov = float(
                    2.0
                    * np.degrees(np.arctan(np.tan(np.radians(hfov) / 2.0) / aspect))
                )
        return Camera(
            c2w=jnp.asarray(c2w),
            origin=jnp.asarray(eye),
            hfov=jnp.float32(hfov),
            vfov=jnp.float32(vfov),
        )


def generate_rays(cam: Camera, xy):
    """Rays through normalized screen coords xy in [0,1]².

    xy: (..., 2).  Returns (ro, rd): (..., 3) origins (broadcast) and unit
    world-space directions.
    """
    tan_h = jnp.tan(jnp.radians(cam.hfov) * 0.5)
    tan_v = jnp.tan(jnp.radians(cam.vfov) * 0.5)
    dx = (2.0 * xy[..., 0:1] - 1.0) * tan_h
    dy = (2.0 * xy[..., 1:2] - 1.0) * tan_v
    d_cam = jnp.concatenate([dx, dy, -jnp.ones_like(dx)], axis=-1)
    # HIGHEST: a GPU may otherwise run an f32 product in TF32 (~3 digits).
    d_world = jnp.matmul(d_cam, cam.c2w.T,
                         precision=jax.lax.Precision.HIGHEST)
    rd = normalize(d_world)
    ro = jnp.broadcast_to(cam.origin, rd.shape)
    return ro, rd


def pixel_xy(width: int, height: int, pixel_ids, jitter):
    """Normalized screen coords for flat pixel ids with sub-pixel jitter.

    pixel_ids: (R,) int32 in [0, W*H); jitter: (R, 2) uniforms in [0,1).
    Pixel (0,0) is the bottom-left of the image; row-major ids with y the
    row index from the bottom (the film module flips for PNG output).
    """
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)
    x = (px[..., None] + jitter[..., 0:1]) / width
    y = (py[..., None] + jitter[..., 1:2]) / height
    return jnp.concatenate([x, y], axis=-1)
