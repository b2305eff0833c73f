"""Render configuration.

Counterpart of the reference's getopt CLI flags (SURVEY.md §2 row 17:
``-t threads -s spp -l light_samples -m max_depth -r w h -f outfile``) plus
the accelerator-batching knobs the reference never needed.  The config is a frozen,
hashable dataclass so it can be a ``jax.jit`` static argument: config ==
compilation key (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs for one render. Hashable; used as a jit static argument."""

    width: int = 512
    height: int = 512
    spp: int = 16                    # samples per pixel (reference: -s)
    max_depth: int = 4               # max ray bounces (reference: -m)
    ns_area_light: int = 1           # samples per area light (reference: -l)
    direct_only: bool = False        # config-1 mode: no indirect bounces
    rr_start: int = 2                # bounce index where Russian roulette kicks in
    rr_prob: float = 0.7             # continuation probability for RR
    # Wavefront machinery
    spp_chunk: int = 4               # spp rendered per device pass (memory knob)
    # Numerics
    dtype: str = "float32"
    eps: float = 1e-4                # shadow/secondary ray offset
    # Sanitizer (SURVEY.md §5): when True the wavefront step runs
    # checkify.check invariants (finite throughput/radiance, positive hit
    # t, valid barycentrics) — render via render_wavefront_checked (or any
    # checkify.checkify wrapper) to surface them as errors.
    debug_checks: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        d = json.loads(s)
        # Knobs removed in r2 (were never read); accept old configs.
        for dead in ("mesh_shape", "ray_block", "compact", "sort_rays",
                     "traversal"):
            d.pop(dead, None)
        return cls(**d)
