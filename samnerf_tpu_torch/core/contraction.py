"""MipNeRF-360 scene contraction (L-inf), counterpart of
``samnerf_tpu/core/contraction.py``."""
from __future__ import annotations

import torch


def scene_contraction(x: torch.Tensor) -> torch.Tensor:
    """f(x) = x if ||x||_inf <= 1 else (2 - 1/||x||) * x/||x||: space into
    the cube [-2, 2]^3."""
    mag = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-12)
    return torch.where(mag < 1.0, x, (2.0 - 1.0 / mag) * (x / mag))


def contract_to_unit(x: torch.Tensor) -> torch.Tensor:
    """Contract, then map [-2, 2] -> [0, 1]."""
    return (scene_contraction(x) + 2.0) / 4.0
