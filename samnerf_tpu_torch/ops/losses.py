"""NeRF losses: interlevel (proposal), distortion, the masked feature MSE,
and the model zoo's normal, depth and MiDaS losses.

Counterpart of ``samnerf_tpu/ops/losses.py``; ``take_along_last``
becomes ``torch.gather``.
"""
from __future__ import annotations

from typing import Optional, Sequence

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


def masked_feature_mse(pred: torch.Tensor, target: torch.Tensor,
                       denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel channel-mean MSE, averaged over the pixels whose target
    is finite (NaN marks a pixel without features).  ``denom`` replaces
    the count of those pixels (floored at 1): a data-parallel rank passes
    the group's count over the world size, so that the ranks' mean of
    this loss is the global batch's."""
    valid = torch.isfinite(target).all(dim=-1)
    target = torch.nan_to_num(target)
    per_pix = torch.mean((pred - target) ** 2, dim=-1)
    if denom is None:
        denom = torch.clamp_min(torch.sum(valid), 1)
    return torch.sum(torch.where(valid, per_pix, 0.0)) / denom


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor,
                     view_dirs: torch.Tensor) -> torch.Tensor:
    """Ref-NeRF's penalty on normals facing away from the camera, [R]:
    weights [R, S, 1], normals [R, S, 3], view_dirs [R, 3]."""
    n_dot_v = torch.sum(normals * view_dirs[..., None, :], dim=-1)
    return torch.sum(weights[..., 0] * torch.clamp_max(n_dot_v, 0.0) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor,
                     pred_normals: torch.Tensor) -> torch.Tensor:
    """Agreement of density-gradient and predicted normals, [R]."""
    return torch.sum(weights[..., 0] * (1.0 - torch.sum(normals * pred_normals, dim=-1)),
                     dim=-1)


def ds_nerf_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor,
                       steps: torch.Tensor, lengths: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    """DS-NeRF's depth likelihood: weights, sample mids ``steps`` and
    interval ``lengths`` [R, S, 1], termination_depth [R, 1] (rays with
    depth <= 0 carry no loss)."""
    depth_mask = (termination_depth > 0).to(weights.dtype)
    loss = -torch.log(weights + 1e-5) * torch.exp(
        -((steps - termination_depth[:, None]) ** 2) / (2 * sigma)) * lengths
    return torch.mean(torch.sum(loss, dim=-2) * depth_mask)


def urban_radiance_field_depth_loss(weights: torch.Tensor,
                                    termination_depth: torch.Tensor,
                                    predicted_depth: torch.Tensor,
                                    steps: torch.Tensor,
                                    sigma: float) -> torch.Tensor:
    """URF's depth loss: expected-depth L2 plus the line-of-sight terms
    (near the surface, weights follow a normalized Gaussian; before it,
    they are zero)."""
    depth_mask = (termination_depth > 0).to(weights.dtype)
    expected_depth_loss = (termination_depth - predicted_depth) ** 2
    td = termination_depth[:, None]
    near_mask = ((steps <= td + sigma) & (steps >= td - sigma)).to(weights.dtype)
    w_target = torch.exp(-((steps - td) ** 2) / (2 * sigma))
    w_target = w_target / torch.clamp_min(torch.sum(w_target, dim=-2, keepdim=True), 1e-6)
    near = torch.sum(near_mask * (weights - w_target) ** 2, dim=-2)
    empty = torch.sum((steps < td - sigma).to(weights.dtype) * weights ** 2, dim=-2)
    return torch.mean((expected_depth_loss + near + empty) * depth_mask)


def midas_scale_shift(prediction: torch.Tensor, target: torch.Tensor,
                      mask: torch.Tensor):
    """Per-image least-squares (scale, shift) [B] taking ``prediction`` to
    ``target`` over ``mask`` [B, H, W]; (0, 0) where the system is
    singular."""
    a00 = torch.sum(mask * prediction * prediction, dim=(-2, -1))
    a01 = torch.sum(mask * prediction, dim=(-2, -1))
    a11 = torch.sum(mask, dim=(-2, -1))
    b0 = torch.sum(mask * prediction * target, dim=(-2, -1))
    b1 = torch.sum(mask * target, dim=(-2, -1))
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe = torch.where(valid, det, 1.0)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe, 0.0)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe, 0.0)
    return scale, shift


def midas_depth_loss(prediction: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor, scales: int = 4) -> torch.Tensor:
    """MiDaS's scale-and-shift-invariant MSE plus 0.5 x the gradient
    matching term at ``scales`` scales; [B, H, W] inputs."""
    scale, shift = midas_scale_shift(prediction, target, mask)
    pred = scale[:, None, None] * prediction + shift[:, None, None]

    def mse_term(p, t, m):
        res = p - t
        num = torch.clamp_min(torch.sum(m, dim=(-2, -1)), 1.0)
        return torch.sum(m * res * res, dim=(-2, -1)) / (2.0 * num)

    def grad_term(p, t, m):
        diff = (p - t) * m
        gx = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * m[:, :, 1:] * m[:, :, :-1]
        gy = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * m[:, 1:, :] * m[:, :-1, :]
        num = torch.clamp_min(torch.sum(m, dim=(-2, -1)), 1.0)
        return (torch.sum(gx, dim=(-2, -1)) + torch.sum(gy, dim=(-2, -1))) / num

    loss = mse_term(pred, target, mask)
    for s in range(scales):
        step = 2 ** s
        loss = loss + 0.5 * grad_term(pred[:, ::step, ::step], target[:, ::step, ::step],
                                      mask[:, ::step, ::step])
    return torch.mean(loss)
