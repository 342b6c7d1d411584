"""The ClipSeg decoder ``CLIPDensePredT`` (``rd64-uni``), counterpart of
``samnerf_tpu/perception/clipseg/clipseg.py``.

CLIP ViT-B/16 activations at layers (3, 6, 9), last first, are each
reduced 768 -> 64 and summed into a running token stream; the first is
conditioned on the text embedding (``film_mul(cond) * a +
film_add(cond)``), each passes one post-norm encoder layer, and the
tokens without the class token are upsampled 16x by a transposed
convolution into dense logits.  :meth:`CLIPDensePredT.decode` is the
distillation path: it takes reduced activations directly, as rendered by
the feature field.

Parameter names are those of ``rd64-uni.pth`` (``reduces.{i}``,
``blocks.{i}.self_attn.in_proj_weight``, ``blocks.{i}.linear1``,
``blocks.{i}.norm1``, ``film_mul``, ``film_add``, ``trans_conv``), so the
checkpoint's decoder keys load as they are: ``trans_conv`` is the
reference's ``ConvTranspose2d`` and takes its weight unflipped.  Tokens
are [B, N, D]; logits come out NHWC, as in the JAX package.
``compute_dtype`` reaches the encoder layers' attention and feed-forward
products (their LayerNorms and residuals stay f32); the reductions, FiLM
and the transposed convolution stay f32, as in the JAX module.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samnerf_tpu_torch.perception.clipseg.clip_model import SelfAttention
from samnerf_tpu_torch.utils.dtypes import layer_norm, linear, resolve_dtype


class TorchTransformerEncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer``'s eval function and parameter names
    (post-norm, ReLU, ``dim_feedforward`` 2048, eps 1e-5) in plain
    operations: that class's eval fast path is a fused kernel with other
    numerics."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.self_attn = SelfAttention(d_model, nhead, compute_dtype, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = layer_norm(x + self.self_attn(x), self.norm1, dt)
        return layer_norm(x + linear(F.relu(linear(x, self.linear1, dt)), self.linear2, dt),
                          self.norm2, dt)


class CLIPDensePredT(nn.Module):
    """The decoder only; the CLIP backbone is a module of its own.
    ``width`` is the CLIP visual width the reductions take (the JAX module
    infers it from its input); the condition is CLIP's 512-d text
    embedding."""

    def __init__(self, extract_layers: Tuple[int, ...] = (3, 6, 9), cond_layer: int = 0,
                 reduce_dim: int = 64, n_heads: int = 4, trans_conv_ks: int = 16,
                 rev_activations: bool = False, width: int = 768,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        depth = len(extract_layers)
        self.extract_layers = tuple(extract_layers)
        self.cond_layer = cond_layer
        self.rev_activations = rev_activations
        self.reduces = nn.ModuleList(
            [nn.Linear(width, reduce_dim, device=device) for _ in range(depth)])
        self.blocks = nn.ModuleList(
            [TorchTransformerEncoderLayer(reduce_dim, n_heads, compute_dtype=compute_dtype,
                                          device=device)
             for _ in range(depth)])
        self.film_mul = nn.Linear(512, reduce_dim, device=device)
        self.film_add = nn.Linear(512, reduce_dim, device=device)
        self.trans_conv = nn.ConvTranspose2d(reduce_dim, 1, trans_conv_ks,
                                             stride=trans_conv_ks, device=device)

    def reduce_activations(self, activations: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each slot's reduced activation [B, N, 64], the last extracted
        layer first: what ``clipseg_features/*.pt`` hold and the field
        renders."""
        acts = list(activations) if self.rev_activations else list(activations)[::-1]
        return [reduce(a) for reduce, a in zip(self.reduces, acts)]

    def decode(self, reduced_activations: Sequence[torch.Tensor],
               cond: torch.Tensor) -> torch.Tensor:
        """depth x [B, N + 1, 64] (class token first), cond [B, 512]
        -> logits [B, H * ks, W * ks, 1]."""
        a = None
        for i, (ra, block) in enumerate(zip(reduced_activations, self.blocks)):
            a = ra if a is None else ra + a
            if i == self.cond_layer:
                a = self.film_mul(cond)[:, None, :] * a + self.film_add(cond)[:, None, :]
            a = block(a)
        a = a[:, 1:, :]
        bs, n, c = a.shape
        size = int(math.sqrt(n))
        a = a.transpose(1, 2).reshape(bs, c, size, size)
        return self.trans_conv(a).permute(0, 2, 3, 1)

    def forward(self, activations: Sequence[torch.Tensor], cond: torch.Tensor) -> torch.Tensor:
        """Raw CLIP activations (depth x [B, N + 1, width]) -> logits."""
        return self.decode(self.reduce_activations(activations), cond)
