"""Volumetric renderers, counterpart of ``samnerf_tpu/ops/rendering.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from samnerf_tpu_torch.core.rays import RaySamples


def render_rgb(rgb: torch.Tensor, weights: torch.Tensor,
               background_color: str = "last_sample",
               bg_rgb: Optional[torch.Tensor] = None,
               training: bool = True) -> torch.Tensor:
    """Composite per-sample rgb [R, S, 3] with weights [R, S, 1] over a
    'last_sample', 'black', 'white' or 'explicit' background (``bg_rgb``
    [3] for all rays, or [R, 3] per ray, as instant-ngp's random training
    background).  Outside training NaNs become 0 and the result is
    clipped to [0, 1]."""
    if not training:
        rgb = torch.nan_to_num(rgb)
    comp_rgb = torch.sum(weights * rgb, dim=-2)
    acc = torch.sum(weights, dim=-2)
    if background_color == "last_sample":
        bg = rgb[..., -1, :]
    elif background_color == "black":
        bg = torch.zeros_like(comp_rgb)
    elif background_color == "white":
        bg = torch.ones_like(comp_rgb)
    elif background_color == "explicit":
        if bg_rgb is None:
            raise ValueError("explicit background needs bg_rgb")
        bg = bg_rgb
    else:
        raise ValueError(background_color)
    comp_rgb = comp_rgb + bg * (1.0 - acc)
    return comp_rgb if training else torch.clamp(comp_rgb, 0.0, 1.0)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """[R, S, 1] -> [R, 1]."""
    return torch.sum(weights, dim=-2)


def render_depth_median(weights: torch.Tensor,
                        ray_samples: RaySamples) -> torch.Tensor:
    """Distance where the cumulative weight crosses 0.5, [R, 1]."""
    steps = (ray_samples.starts + ray_samples.ends) / 2.0
    cum = torch.cumsum(weights[..., 0], dim=-1)
    idx = torch.sum((cum < 0.5).long(), dim=-1, keepdim=True)
    idx = torch.clamp(idx, 0, steps.shape[-2] - 1)
    return torch.gather(steps[..., 0], -1, idx)


def render_depth_expected(weights: torch.Tensor, ray_samples: RaySamples,
                          eps: float = 1e-10) -> torch.Tensor:
    """Weight-averaged sample mid [R, 1], clipped to the range of all the
    bundle's sample mids."""
    steps = (ray_samples.starts + ray_samples.ends) / 2.0
    depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
    return torch.clamp(depth, torch.min(steps), torch.max(steps))


def render_mean(embeds: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of per-sample embeddings [R, K, C] -> [R, C]."""
    return torch.sum(weights * embeds, dim=-2)


def topk_sharpened_weights(weights: torch.Tensor, k: int,
                           temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k weights re-sorted by sample index, raised to ``temperature``
    and renormalized: (sharpened [R, k, 1], ids [R, k])."""
    w, ids = torch.topk(weights[..., 0], k, dim=-1)
    ids, order = torch.sort(ids, dim=-1)
    w = torch.gather(w, -1, order) ** temperature
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-37)
    return w[..., None], ids


def render_semantics(semantics: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of per-sample class logits [R, S, C] -> [R, C]."""
    return torch.sum(weights * semantics, dim=-2)


def render_uncertainty(betas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of per-sample uncertainties [R, S, 1] -> [R, 1]."""
    return torch.sum(weights * betas, dim=-2)


def render_normals(normals: torch.Tensor, weights: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """Weighted sum of per-sample normals [R, S, 3] -> [R, 3], by default
    scaled to unit length (at least 1e-9 before scaling)."""
    n = torch.sum(weights * normals, dim=-2)
    if normalize:
        n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-9)
    return n
