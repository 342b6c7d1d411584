"""SAM two-way transformer, counterpart of
``samnerf_tpu/perception/sam/transformer.py`` (reference torch names;
NHWC image embeddings as in the JAX package)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from samnerf_tpu_torch.perception.sam.common import MLPBlock


class Attention(nn.Module):
    """Multi-head attention with a channel downsample rate."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1, device="cuda"):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.k_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.v_proj = nn.Linear(embedding_dim, self.internal_dim, device=device)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim, device=device)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = torch.softmax(attn, dim=-1) @ v
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False, device="cuda"):
        super().__init__()
        self.self_attn = Attention(embedding_dim, num_heads, device=device)
        self.norm1 = nn.LayerNorm(embedding_dim, device=device)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, device=device)
        self.norm2 = nn.LayerNorm(embedding_dim, device=device)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, nn.ReLU, device=device)
        self.norm3 = nn.LayerNorm(embedding_dim, device=device)
        self.norm4 = nn.LayerNorm(embedding_dim, device=device)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate, device=device)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):

    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0), device=device)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate, device=device)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, device=device)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding / image_pe [B, h, w, C] -> (queries, keys)."""
        bs, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(bs, h * w, c)
        image_pe = image_pe.reshape(image_pe.shape[0], h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
