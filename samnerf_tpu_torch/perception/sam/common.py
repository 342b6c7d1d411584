"""LayerNorm2d and MLPBlock, counterpart of the two small modules at the
top of ``samnerf_tpu/perception/sam/image_encoder.py`` (the ViT itself is
not on the serve path and waits)."""
from __future__ import annotations

from typing import Type

import torch
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel dim of NCHW features, eps 1e-6."""

    def __init__(self, num_channels: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    """Linear -> activation -> Linear."""

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 act: Type[nn.Module] = nn.GELU, device="cuda"):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim, device=device)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim, device=device)
        self.act = act()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))
