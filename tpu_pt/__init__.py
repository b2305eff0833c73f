"""tpu_pt — differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``Khrylx/DSGPURayTracing`` (a CUDA + distributed GPU path tracer built on the
CMU 15-462 asst3 "PathTracer" codebase; see SURVEY.md — the reference mount
was empty, so citations are to SURVEY.md sections instead of file:line).

Design stance (SURVEY.md §7): data-oriented and batch-first.  The scene is a
pytree of flat device arrays; the renderer is a pure function
``image = render(scene, camera, config, key)``; bounce depth is a ``lax.scan``
over a wavefront of rays; divergence is handled by masking + stream
compaction; differentiation is plain reverse-mode AD with DETACHED sampling
(``stop_gradient`` on all Monte-Carlo decisions — see tpu_pt/diff/adjoint.py
for the estimator's precise scope); distribution is ``shard_map`` tile
sharding over a ``jax.sharding.Mesh``.
"""

from tpu_pt.config import RenderConfig
from tpu_pt.scene.types import (
    Scene, Materials, Lights, MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS,
    MAT_REFRACT, MAT_EMISSIVE, MAT_GGX,
)
from tpu_pt.core.camera import Camera

__version__ = "0.1.0"
