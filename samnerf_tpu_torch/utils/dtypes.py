"""The ``compute_dtype`` values the port takes, counterpart of the dtype
that the JAX package's modules hand to flax (``SAMModelConfig
.compute_dtype`` and the modules' own ``compute_dtype`` fields).

Parameters stay float32 in every module; ``compute_dtype`` sets the type
the matrix products and convolutions run in.  ``float16``, which JAX
would also take, is not ported.  The helpers below reproduce the rounding
points of the flax operations a bf16 JAX model runs (op by op); on f32
tensors each is the plain torch call, so f32 results are unchanged.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_dtype(value: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (the CLI's strings) or the torch
    dtype -> the torch dtype; anything else raises ``ValueError``."""
    if isinstance(value, torch.dtype) and value in (torch.float32, torch.bfloat16):
        return value
    if isinstance(value, str) and value in ("float32", "bfloat16"):
        return getattr(torch, value)
    raise ValueError(f"compute_dtype must be one of 'float32', 'bfloat16', "
                     f"torch.float32 or torch.bfloat16, got {value!r}")


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on f32 parameters: x and the weight
    cast to ``dtype``, the product rounded to ``dtype``, then the bias cast
    and added (a second rounding).  In f32 this is ``F.linear(x, weight,
    bias)``."""
    if dtype == torch.float32:
        return torch.nn.functional.linear(x, weight, bias)
    out = torch.nn.functional.linear(x.to(dtype), weight.to(dtype))
    return out if bias is None else out + bias.to(dtype)


def linear(x: torch.Tensor, layer: torch.nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """:func:`dense` with an ``nn.Linear``'s parameters."""
    return dense(x, layer.weight, layer.bias, dtype)


def conv2d(x: torch.Tensor, conv: torch.nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` on an f32 NCHW layer: the input and
    kernel cast to ``dtype``, the convolution rounded to ``dtype``, then the
    bias cast and added.  In f32 this is ``conv(x)``."""
    if dtype == torch.float32:
        return conv(x)
    out = torch.nn.functional.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                                     conv.stride, conv.padding, conv.dilation, conv.groups)
    return out if conv.bias is None else out + conv.bias.to(dtype)[:, None, None]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``; on a bf16 tensor JAX's bf16 logistic, ``1 / (1 +
    exp(-x))`` with every operation rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


_SQRT_HALF_BF16 = 0.70703125          # np.sqrt(0.5) rounded to bf16


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU; on a bf16 tensor ``jax.nn.gelu``'s ``0.5 x
    erfc(-x sqrt(0.5))`` with every operation rounded to bf16, as JAX
    computes it op by op."""
    if x.dtype != torch.bfloat16:
        return torch.nn.functional.gelu(x)
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF_BF16)


class GELU(torch.nn.Module):
    """:func:`gelu` as a module (``nn.GELU`` in f32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def layer_norm(x: torch.Tensor, norm: torch.nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """``norm(x)`` in f32.  Otherwise flax's ``nn.LayerNorm`` with f32
    parameters, as the JAX modules run it in a bf16 model: on x upcast to
    f32, the variance as E[x^2] - E[x]^2 (clipped at 0), y = (x - mean)
    (rsqrt(var + eps) scale) + bias, returned in f32.  Its output feeds a
    bf16 cast, so the two variance formulas' f32 differences would show."""
    if dtype == torch.float32:
        return norm(x)
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias


def scalar(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``: a weak
    type, rounded to ``dtype`` first (bf16 x * 0.17677 multiplies by
    bf16(0.17677)).  torch would multiply by the f32 constant, so bf16
    code rounds it here; f32 code gets ``value`` back."""
    if dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))
