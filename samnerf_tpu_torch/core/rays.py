"""Rays and samples along them.

Counterpart of ``samnerf_tpu/core/rays.py``.  ``RaySamples`` keeps
per-ray fields un-broadcast (``origins`` stays [R, 3]) and stores the
spacing-domain ``s_near`` / ``s_far`` per ray; positions are computed on
demand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """A flat batch of rays; every field has leading shape [R]."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3] unit vectors
    pixel_area: torch.Tensor  # [R, 1]
    camera_indices: Optional[torch.Tensor] = None  # [R, 1] int
    nears: Optional[torch.Tensor] = None  # [R, 1]
    fars: Optional[torch.Tensor] = None  # [R, 1]
    times: Optional[torch.Tensor] = None  # [R, 1] in [0, 1]

    def with_near_far(self, near: float, far: float) -> "RayBundle":
        """NearFarCollider: constant near/far for every ray."""
        ones = torch.ones_like(self.origins[..., :1])
        return dataclasses.replace(self, nears=ones * near, fars=ones * far)


@dataclasses.dataclass(frozen=True)
class RaySamples:
    """Samples along rays, shape [R, S]; ``spacing_*`` are the normalized
    bin edges before the spacing warp."""

    origins: torch.Tensor  # [R, 3]
    directions: torch.Tensor  # [R, 3]
    starts: torch.Tensor  # [R, S, 1] euclidean bin starts
    ends: torch.Tensor  # [R, S, 1]
    spacing_starts: torch.Tensor  # [R, S, 1]
    spacing_ends: torch.Tensor  # [R, S, 1]
    s_near: torch.Tensor  # [R, 1]
    s_far: torch.Tensor  # [R, 1]
    pixel_area: Optional[torch.Tensor] = None  # [R, 1]
    camera_indices: Optional[torch.Tensor] = None  # [R, 1] int
    times: Optional[torch.Tensor] = None  # [R, 1] in [0, 1]

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    def positions(self) -> torch.Tensor:
        """Frustum centers o + d * (t0 + t1) / 2, [R, S, 3]."""
        mids = (self.starts + self.ends) * 0.5
        return self.origins[..., None, :] + self.directions[..., None, :] * mids

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """Compositing weights w = alpha * T, [R, S, 1]."""
        return render_weights_from_density(self.deltas, densities)

    def take_topk(self, ids: torch.Tensor) -> "RaySamples":
        """Keep samples ``ids`` [R, K] along the sample axis."""
        def g(x):
            return torch.gather(x, -2, ids[..., None])

        return dataclasses.replace(
            self, starts=g(self.starts), ends=g(self.ends),
            spacing_starts=g(self.spacing_starts),
            spacing_ends=g(self.spacing_ends))


def render_weights_from_density(deltas: torch.Tensor,
                                densities: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * T_i with T_i = exp(-sum_{j<i} delta_j sigma_j)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    csum = torch.cumsum(delta_density[..., :-1, :], dim=-2)
    csum = torch.cat([torch.zeros_like(csum[..., :1, :]), csum], dim=-2)
    return torch.nan_to_num(alphas * torch.exp(-csum))
