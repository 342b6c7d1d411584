"""SAM ViT-Det image encoder, counterpart of
``samnerf_tpu/perception/sam/image_encoder.py``.

A 1024^2 image gives a 64x64x256 embedding: the patch-embed conv, an
absolute position embedding, transformer blocks with 14x14 window
attention except the global layers, a decomposed relative-position bias,
and a two-conv neck with channel LayerNorms.  Module and parameter names
are the reference torch SAM's (``patch_embed.proj``, ``blocks.{i}.attn
.{qkv,proj,rel_pos_h,rel_pos_w}``, ``neck.{0..3}``), so a
``sam_vit_*.pth`` state dict loads as it is.  The public layout is the
JAX package's: NHWC in and out; the convolutions run NCHW inside.

Global layers with rel-pos and at least ``flash_min_tokens`` tokens go
through FLASH-RELPOS (``ops/attention.py``) when ``use_flash`` is set,
the fields and condition of the JAX ``Attention`` without its TPU backend
and tiling tests; the 14x14 windows stay plain PyTorch.

``compute_dtype`` follows the JAX encoder's rounding points: the patch
embedding, ``qkv``, ``proj``, the MLPs and the neck convolutions run in
it (parameters stay f32), the residual stream is in it, the LayerNorms
compute and return f32 (``LayerNorm2d`` returns its input's dtype), a
window's logits, bias and ``attn @ v`` are in it with the softmax in f32,
the global layers give FLASH-RELPOS operands of that dtype, and the
output is f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samnerf_tpu_torch.ops.attention import attention_relpos
from samnerf_tpu_torch.perception.sam.common import LayerNorm2d, MLPBlock
from samnerf_tpu_torch.utils.dtypes import conv2d, layer_norm, linear, resolve_dtype, scalar


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Rel-pos rows for every (query, key) offset, linearly resized
    (``F.interpolate`` 'linear', align_corners=False) when the table was
    trained at another size -> [q_size, k_size, C]."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        rel_pos = resized.reshape(-1, max_rel_dist).permute(1, 0)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def decomposed_rel_terms(q: torch.Tensor, rel_pos_h: torch.Tensor,
                         rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                         k_size: Tuple[int, int]):
    """q [B, qh*qw, C] -> (rel_h [B, qh, qw, kh], rel_w [B, qh, qw, kw]),
    the bias terms contracted with q."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    r_q = q.reshape(q.shape[0], q_h, q_w, q.shape[-1])
    return (torch.einsum("bhwc,hkc->bhwk", r_q, Rh),
            torch.einsum("bhwc,wkc->bhwk", r_q, Rw))


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor,
                           rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           q_size: Tuple[int, int], k_size: Tuple[int, int]) -> torch.Tensor:
    """attn [B, qh*qw, kh*kw] + rel_h[q, kh] + rel_w[q, kw]."""
    rel_h, rel_w = decomposed_rel_terms(q, rel_pos_h, rel_pos_w, q_size, k_size)
    B = q.shape[0]
    attn = attn.reshape(B, *q_size, *k_size)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(B, q_size[0] * q_size[1], k_size[0] * k_size[1])


def window_partition(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([B*nw, ws, ws, C], (Hp, Wp)), zero-padded to whole
    windows."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`, the padding cut off."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class Attention(nn.Module):
    """Multi-head attention with an optional decomposed rel-pos bias."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 use_rel_pos: bool = False,
                 input_size: Optional[Tuple[int, int]] = None,
                 use_flash: bool = True, flash_min_tokens: int = 1024,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.use_rel_pos = use_rel_pos
        self.use_flash = use_flash
        self.flash_min_tokens = flash_min_tokens
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, head_dim, device=device))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_size[1] - 1, head_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        n = H * W
        dt = self.compute_dtype
        qkv = linear(x, self.qkv, dt).reshape(B, n, 3, self.num_heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * self.num_heads, n, -1)
        if self.use_flash and self.use_rel_pos and n >= self.flash_min_tokens:
            rel_h, rel_w = decomposed_rel_terms(q, self.rel_pos_h, self.rel_pos_w,
                                                (H, W), (H, W))
            x = attention_relpos(q.contiguous(), k.contiguous(), v.contiguous(),
                                 rel_h.reshape(-1, n, H).contiguous(),
                                 rel_w.reshape(-1, n, W).contiguous(), self.scale)
        else:
            attn = (q * scalar(self.scale, q.dtype)) @ k.transpose(-2, -1)
            if self.use_rel_pos:
                attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w,
                                              (H, W), (H, W))
            x = torch.softmax(attn.float(), dim=-1).to(q.dtype) @ v
        x = x.reshape(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4)
        return linear(x.reshape(B, H, W, -1), self.proj, dt)


class Block(nn.Module):
    """Transformer block with window (``window_size`` > 0) or global
    attention; the LayerNorms use eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_rel_pos: bool = False,
                 window_size: int = 0, input_size: Optional[Tuple[int, int]] = None,
                 use_flash: bool = True, flash_min_tokens: int = 1024,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = Attention(
            dim, num_heads=num_heads, qkv_bias=qkv_bias, use_rel_pos=use_rel_pos,
            input_size=input_size if window_size == 0 else (window_size, window_size),
            use_flash=use_flash, flash_min_tokens=flash_min_tokens,
            compute_dtype=compute_dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), compute_dtype=compute_dtype,
                            device=device)
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.attn.compute_dtype
        shortcut = x
        x = layer_norm(x, self.norm1, dt)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(layer_norm(x, self.norm2, dt))


class PatchEmbed(nn.Module):
    """The patch-embed conv in ``compute_dtype``, NCHW in, NHWC out."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size, device=device)
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.proj, self.compute_dtype).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """NHWC [B, img, img, 3] (normalised, padded) -> NHWC [B, img/patch,
    img/patch, out_chans]."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256, qkv_bias: bool = True,
                 use_abs_pos: bool = True, use_rel_pos: bool = True,
                 window_size: int = 14, global_attn_indexes: Tuple[int, ...] = (),
                 use_flash: bool = True, flash_min_tokens: int = 1024,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.img_size = img_size
        self.embed_size = img_size // patch_size
        grid = (self.embed_size, self.embed_size)
        self.patch_embed = PatchEmbed(patch_size, embed_dim,
                                      compute_dtype=compute_dtype, device=device)
        self.pos_embed = (nn.Parameter(torch.zeros(1, *grid, embed_dim, device=device))
                          if use_abs_pos else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                  use_rel_pos=use_rel_pos,
                  window_size=0 if i in global_attn_indexes else window_size,
                  input_size=grid, use_flash=use_flash,
                  flash_min_tokens=flash_min_tokens, compute_dtype=compute_dtype,
                  device=device)
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, kernel_size=1, bias=False, device=device),
            LayerNorm2d(out_chans, device=device),
            nn.Conv2d(out_chans, out_chans, kernel_size=3, padding=1, bias=False,
                      device=device),
            LayerNorm2d(out_chans, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = x.permute(0, 3, 1, 2)
        for layer in self.neck:
            x = (conv2d(x, layer, self.compute_dtype) if isinstance(layer, nn.Conv2d)
                 else layer(x))
        return x.permute(0, 2, 3, 1).float()
