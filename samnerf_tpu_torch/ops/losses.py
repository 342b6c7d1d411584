"""NeRF losses: interlevel (proposal), distortion and the masked feature MSE.

Counterpart of ``samnerf_tpu/ops/losses.py:22-91``; ``take_along_last``
becomes ``torch.gather``.  The normal, depth and MiDaS losses serve the
model zoo and wait.
"""
from __future__ import annotations

from typing import Sequence

import torch

from samnerf_tpu_torch.core.rays import RaySamples
from samnerf_tpu_torch.ops.samplers import searchsorted_right

EPS = 1e-7


def ray_samples_to_sdist(ray_samples: RaySamples) -> torch.Tensor:
    """Bin edges in normalized s-space [R, S+1]."""
    return torch.cat([ray_samples.spacing_starts[..., 0],
                      ray_samples.spacing_ends[..., -1:, 0]], dim=-1)


def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """Sum of y1 mass inside each (t0_start, t0_end) interval."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    idx_lo = torch.clamp(searchsorted_right(t1_starts, t0_starts) - 1, 0, last)
    idx_hi = torch.clamp(searchsorted_right(t1_ends, t0_ends), 0, last)
    cy1_lo = torch.gather(cy1[..., :-1], -1, idx_lo)
    cy1_hi = torch.gather(cy1[..., 1:], -1, idx_hi)
    return cy1_hi - cy1_lo


def lossfun_outer(t, w, t_env, w_env):
    """Histogram-bound penalty."""
    w_outer = outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def interlevel_loss(weights_list: Sequence[torch.Tensor],
                    ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """MipNeRF-360 proposal loss: the last level is the detached target;
    each proposal level is penalized for under-covering it."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        sdist = ray_samples_to_sdist(ray_samples)
        loss = loss + torch.mean(lossfun_outer(c, w, sdist, weights[..., 0]))
    return loss


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MipNeRF-360 distortion, O(S^2) form."""
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(weights_list: Sequence[torch.Tensor],
                    ray_samples_list: Sequence[RaySamples]) -> torch.Tensor:
    """Applied to the final nerf level only."""
    c = ray_samples_to_sdist(ray_samples_list[-1])
    w = weights_list[-1][..., 0]
    return torch.mean(lossfun_distortion(c, w))


def masked_feature_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel channel-mean MSE, averaged over the pixels whose target
    is finite (NaN marks a pixel without features)."""
    valid = torch.isfinite(target).all(dim=-1)
    target = torch.nan_to_num(target)
    per_pix = torch.mean((pred - target) ** 2, dim=-1)
    denom = torch.clamp_min(torch.sum(valid), 1)
    return torch.sum(torch.where(valid, per_pix, 0.0)) / denom
