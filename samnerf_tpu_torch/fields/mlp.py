"""ReLU MLPs and the truncated-exp density activation, counterpart of
``samnerf_tpu/fields/mlp.py`` (f32)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with a clamped gradient: forward exp(x), backward
    g * exp(clamp(x, -15, 15))."""
    return _TruncExp.apply(x)


class MLP(nn.Module):
    """``num_hidden_layers`` ReLU layers of ``hidden_dim``, linear out,
    optional output activation.  ``layers.i`` is flax ``Dense_i``."""

    def __init__(self, in_dim: int, hidden_dim: int, num_hidden_layers: int,
                 out_dim: int, output_activation: Optional[Callable] = None,
                 device="cuda"):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * num_hidden_layers + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))
        self.output_activation = output_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        if self.output_activation is not None:
            x = self.output_activation(x)
        return x
