"""LayerNorm2d and MLPBlock, counterpart of the two small modules at the
top of ``samnerf_tpu/perception/sam/image_encoder.py``, shared by the ViT
image encoder (``image_encoder.py``), the prompt encoder and the mask
decoder."""
from __future__ import annotations

from typing import Type

import torch
from torch import nn

from samnerf_tpu_torch.utils.dtypes import GELU, linear, resolve_dtype


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel dim of NCHW features, eps 1e-6,
    computed in f32 and returned in the input's dtype."""

    def __init__(self, num_channels: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype, x = x.dtype, x.float()
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return (self.weight[:, None, None] * x + self.bias[:, None, None]).to(dtype)


class MLPBlock(nn.Module):
    """Linear -> activation -> Linear, all in ``compute_dtype``."""

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 act: Type[nn.Module] = GELU, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim, device=device)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim, device=device)
        self.act = act()
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return linear(self.act(linear(x, self.lin1, dt)), self.lin2, dt)
