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
    'last_sample', 'black', 'white' or 'explicit' (``bg_rgb`` [3])
    background.  Outside training NaNs become 0 and the result is
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
