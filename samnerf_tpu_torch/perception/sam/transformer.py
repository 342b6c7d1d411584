"""SAM two-way transformer, counterpart of
``samnerf_tpu/perception/sam/transformer.py`` (reference torch names;
NHWC image embeddings as in the JAX package).  With ``compute_dtype`` the
projections and MLPs run in that dtype, the logits are cast to f32 for the
softmax and the weights back, and the LayerNorms compute and return f32
(so the residual streams stay f32), as the JAX module does.

``token_valid`` ([B, N] bool, optional) marks which prompt tokens are
real: the rest are the padding of a static prompt bucket, and every
attention that reads the tokens as keys (the token self-attention and the
image-to-token one) gives them zero weight, so the real tokens' outputs
are those of the unpadded prompt.  ``None`` masks nothing."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.perception.sam.common import MLPBlock
from samnerf_tpu_torch.utils.dtypes import layer_norm, linear, resolve_dtype, scalar


class Attention(nn.Module):
    """Multi-head attention with a channel downsample rate."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1, compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.k_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.v_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim, device=device)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v, key_valid: Optional[torch.Tensor] = None):
        """``key_valid`` [B, Nk] bool: keys left out of the softmax."""
        dt = self.compute_dtype
        q = self._split(linear(q, self.q_proj, dt))
        k = self._split(linear(k, self.k_proj, dt))
        v = self._split(linear(v, self.v_proj, dt))
        attn = (q @ k.transpose(-2, -1)) / scalar(math.sqrt(q.shape[-1]), q.dtype)
        attn = attn.float()
        if key_valid is not None:
            attn = attn.masked_fill(~key_valid[:, None, None, :], -math.inf)
        out = torch.softmax(attn, dim=-1).to(q.dtype) @ v
        b, h, n, d = out.shape
        return linear(out.transpose(1, 2).reshape(b, n, h * d), self.out_proj, dt)


class TwoWayAttentionBlock(nn.Module):

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dt = compute_dtype
        self.self_attn = Attention(embedding_dim, num_heads, compute_dtype=dt,
                                   device=device)
        self.norm1 = nn.LayerNorm(embedding_dim, device=device)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, compute_dtype=dt,
            device=device)
        self.norm2 = nn.LayerNorm(embedding_dim, device=device)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, nn.ReLU, compute_dtype=dt,
                            device=device)
        self.norm3 = nn.LayerNorm(embedding_dim, device=device)
        self.norm4 = nn.LayerNorm(embedding_dim, device=device)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate, compute_dtype=dt,
            device=device)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe, token_valid=None):
        dt = self.self_attn.compute_dtype
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries, token_valid)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries, token_valid)
        queries = layer_norm(queries, self.norm1, dt)

        q, k = queries + query_pe, keys + key_pe
        queries = layer_norm(queries + self.cross_attn_token_to_image(q, k, keys),
                             self.norm2, dt)
        queries = layer_norm(queries + self.mlp(queries), self.norm3, dt)

        q, k = queries + query_pe, keys + key_pe
        keys = layer_norm(keys + self.cross_attn_image_to_token(k, q, queries, token_valid),
                          self.norm4, dt)
        return queries, keys


class TwoWayTransformer(nn.Module):

    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, compute_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0),
                                 compute_dtype=compute_dtype, device=device)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate,
            compute_dtype=compute_dtype, device=device)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, device=device)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor,
                token_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding / image_pe [B, h, w, C] -> (queries, keys)."""
        bs, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(bs, h * w, c)
        image_pe = image_pe.reshape(image_pe.shape[0], h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe, token_valid)
        q, k = queries + point_embedding, keys + image_pe
        queries = layer_norm(queries + self.final_attn_token_to_image(q, k, keys),
                             self.norm_final_attn,
                             self.final_attn_token_to_image.compute_dtype)
        return queries, keys
