"""OpenAI CLIP ViT-B/16, its visual and text towers, counterpart of
``samnerf_tpu/perception/clipseg/clip_model.py``.

Pre-norm residual blocks with QuickGELU; the visual tower embeds patches
with a bias-free convolution, prepends a class token and returns the
projected class token and the activations after the requested blocks,
resizing its position grid (bicubic, as ``jax.image.resize`` does) when
the input is not ``input_resolution``; the text tower runs a causal
transformer and pools at the end-of-text token (the largest id).
Attention is a plain matmul and softmax, as the JAX package computes it.
With ``compute_dtype`` the projections, MLPs and the patch convolution run
in that dtype (parameters stay f32), the softmax in f32 with its weights
cast back, and the LayerNorms return f32, so the residual stream is f32,
as in the JAX module.

Module and parameter names are OpenAI CLIP's (``conv1``,
``transformer.resblocks.{i}.{ln_1,attn.in_proj_weight,attn.out_proj,
ln_2,mlp.c_fc,mlp.c_proj}``, ``token_embedding``, ``text_projection``,
...), so a reference state dict loads through :func:`load_clip_state_dict`
(the visual tower's keys under ``visual.``).  Tokens are [B, N, D]; the
visual tower takes NHWC images, as the JAX one does.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.utils.dtypes import (conv2d, dense, layer_norm, linear, resolve_dtype,
                                            scalar, sigmoid)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(scalar(1.702, x.dtype) * x)


class SelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), computed
    as (q kᵀ) * head_dim ** -0.5 (+ mask), softmax in f32, times v."""

    def __init__(self, d_model: int, n_head: int, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        B, N, D = x.shape
        head = D // self.n_head
        dt = self.compute_dtype
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, dt)
        q, k, v = qkv.reshape(B, N, 3, self.n_head, head).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-2, -1)) * scalar(head ** -0.5, q.dtype)
        if attn_mask is not None:
            attn = attn + attn_mask
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return linear(out, self.out_proj, dt)


class _MLP(nn.Module):
    def __init__(self, d_model: int, compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.c_fc = nn.Linear(d_model, 4 * d_model, device=device)
        self.c_proj = nn.Linear(4 * d_model, d_model, device=device)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x):
        dt = self.compute_dtype
        return linear(quick_gelu(linear(x, self.c_fc, dt)), self.c_proj, dt)


class ResidualAttentionBlock(nn.Module):
    """x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, d_model: int, n_head: int, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.attn = SelfAttention(d_model, n_head, compute_dtype, device=device)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.mlp = _MLP(d_model, compute_dtype, device=device)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        dt = self.attn.compute_dtype
        x = x + self.attn(layer_norm(x, self.ln_1, dt), attn_mask)
        return x + self.mlp(layer_norm(x, self.ln_2, dt))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, compute_dtype, device=device)
             for _ in range(layers)])


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at |offset| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def bicubic_resize_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights of ``jax.image.resize(...,
    "bicubic")`` along one axis: half-pixel centres, Keys' kernel with
    a = -0.5 (widened by in / out when shrinking, the antialias default),
    each output's taps renormalised to sum to 1 (so taps outside the grid
    drop out), in f32 as JAX computes them."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


class CLIPVisual(nn.Module):
    """CLIP's VisionTransformer, NHWC in; keys as under ``visual.``."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.input_resolution = input_resolution
        self.patch_size = patch_size
        self.width = width
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False,
                               device=device)
        grid = input_resolution // patch_size
        self.class_embedding = nn.Parameter(torch.zeros(width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, width, device=device))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5, device=device)
        self.transformer = Transformer(width, layers, heads, compute_dtype, device=device)
        self.ln_post = nn.LayerNorm(width, eps=1e-5, device=device)
        self.proj = nn.Parameter(torch.zeros(width, output_dim, device=device))
        self._resize: Dict[Tuple[int, int, str], torch.Tensor] = {}

    def _resize_matrix(self, in_size: int, out_size: int) -> torch.Tensor:
        dev = self.positional_embedding.device
        key = (in_size, out_size, str(dev))
        if key not in self._resize:
            self._resize[key] = bicubic_resize_matrix(in_size, out_size, dev)
        return self._resize[key]

    def rescaled_pos_emb(self, new_size: Tuple[int, int]) -> torch.Tensor:
        """The position grid resized to ``new_size`` (bicubic, each axis
        that changes size by its weight matrix) -> [h*w + 1, width]."""
        grid = self.input_resolution // self.patch_size
        pe = self.positional_embedding[1:].reshape(grid, grid, self.width)
        if new_size[0] != grid:
            pe = torch.einsum("io,ijc->ojc", self._resize_matrix(grid, new_size[0]), pe)
        if new_size[1] != grid:
            pe = torch.einsum("jp,ojc->opc", self._resize_matrix(grid, new_size[1]), pe)
        pe = pe.reshape(new_size[0] * new_size[1], self.width)
        return torch.cat([self.positional_embedding[:1], pe], dim=0)

    def forward(self, x: torch.Tensor, extract_layers: Sequence[int] = ()
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, H, W, 3] normalized -> (projected class token [B,
        output_dim], the activations [B, tokens + 1, width] after each block
        in ``extract_layers``)."""
        x = conv2d(x.permute(0, 3, 1, 2), self.conv1, self.compute_dtype)  # [B, width, gh, gw]
        B, _, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        grid = self.input_resolution // self.patch_size
        pos = (self.positional_embedding if x.shape[1] == grid * grid + 1
               else self.rescaled_pos_emb((gh, gw)))
        x = layer_norm(x + pos[None].to(x.dtype), self.ln_pre, self.compute_dtype)
        activations = []
        for i, blk in enumerate(self.transformer.resblocks):
            x = blk(x)
            if i in extract_layers:
                activations.append(x)
        return layer_norm(x[:, 0, :], self.ln_post, self.compute_dtype) @ self.proj, activations


class CLIPText(nn.Module):
    """CLIP's text tower: token and position embeddings, a causal
    transformer, the end-of-text token projected."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = 512,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width, device=device))
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.transformer = Transformer(width, layers, heads, compute_dtype, device=device)
        self.ln_final = nn.LayerNorm(width, eps=1e-5, device=device)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, context_length] -> [B, output_dim]."""
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[None]
        n = self.context_length
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for blk in self.transformer.resblocks:
            x = blk(x, attn_mask=mask)
        x = layer_norm(x, self.ln_final, self.compute_dtype)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def load_subset(module: nn.Module, state: Mapping[str, torch.Tensor], prefix: str = "",
                device="cuda") -> None:
    """Load ``module``'s own keys from ``state`` (under ``prefix``) as
    float32 tensors on ``device``, assigned (so ``module`` may live on the
    meta device); other keys of ``state`` are ignored, a missing one
    raises."""
    missing = [k for k in module.state_dict() if prefix + k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {prefix}{missing[0]}")
    module.load_state_dict({k: state[prefix + k].to(device, torch.float32)
                            for k in module.state_dict()}, strict=True, assign=True)


def load_clip_state_dict(visual: CLIPVisual, text: CLIPText,
                         state: Mapping[str, torch.Tensor], device="cuda") -> None:
    """An OpenAI CLIP state dict into the two towers."""
    load_subset(visual, state, "visual.", device)
    load_subset(text, state, "", device)
