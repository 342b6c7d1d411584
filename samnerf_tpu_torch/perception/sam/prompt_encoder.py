"""SAM prompt encoder, counterpart of
``samnerf_tpu/perception/sam/prompt_encoder.py``.

Module and parameter names are the reference torch SAM's, so a
``sam_vit_*.pth`` state dict loads as it is.  Points may be padded to a
static count with label -1 (the reference's own padding token); dense
embeddings are NHWC like the JAX package's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.perception.sam.common import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random spatial-frequency positional encoding."""

    def __init__(self, num_pos_feats: int = 64, device="cuda"):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.empty((2, num_pos_feats), device=device))

    def _pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense grid PE -> [H, W, C]."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
        return self._pe_encoding(grid)

    def forward_with_coords(self, coords: torch.Tensor,
                            image_size: Tuple[int, int]) -> torch.Tensor:
        """coords [..., 2] in pixels (x, y) -> [..., C]."""
        scaled = torch.stack([coords[..., 0] / image_size[1],
                              coords[..., 1] / image_size[0]], dim=-1)
        return self._pe_encoding(scaled)


class PromptEncoder(nn.Module):

    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16, device="cuda"):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2, device=device)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim, device=device) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim, device=device)
        c = mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, kernel_size=2, stride=2, device=device),
            LayerNorm2d(c // 4, device=device), nn.GELU(),
            nn.Conv2d(c // 4, c, kernel_size=2, stride=2, device=device),
            LayerNorm2d(c, device=device), nn.GELU(),
            nn.Conv2d(c, embed_dim, kernel_size=1, device=device))
        self.no_mask_embed = nn.Embedding(1, embed_dim, device=device)

    def get_dense_pe(self) -> torch.Tensor:
        """[1, H, W, C]."""
        return self.pe_layer(self.image_embedding_size)[None]

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool) -> torch.Tensor:
        """points [B, N, 2] (x, y) pixels; labels [B, N] in {-1, 0, 1}."""
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros((points.shape[0], 1, 2))],
                               dim=1)
            labels = torch.cat([labels, -labels.new_ones((labels.shape[0], 1))],
                               dim=1)
        pe = self.pe_layer.forward_with_coords(points, self.input_image_size)
        lab = labels[..., None]
        zero = pe.new_zeros(())
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        emb = emb + torch.where(lab == 0, self.point_embeddings[0].weight[0], zero)
        emb = emb + torch.where(lab == 1, self.point_embeddings[1].weight[0], zero)
        return emb

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, 4] -> [B, 2, C]."""
        coords = (boxes + 0.5).reshape(-1, 2, 2)
        emb = self.pe_layer.forward_with_coords(coords, self.input_image_size)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return emb + corner

    def _embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks [B, 4*eh, 4*ew, 1] NHWC -> [B, eh, ew, C]."""
        x = self.mask_downscaling(masks.permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None):
        """Returns (sparse [B, N, C], dense [B, eh, ew, C])."""
        if points is not None:
            bs, dev = points[0].shape[0], points[0].device
        elif boxes is not None:
            bs, dev = boxes.shape[0], boxes.device
        elif masks is not None:
            bs, dev = masks.shape[0], masks.device
        else:
            bs, dev = 1, self.no_mask_embed.weight.device
        sparse = torch.zeros((bs, 0, self.embed_dim), device=dev)
        if points is not None:
            coords, labels = points
            sparse = torch.cat(
                [sparse, self._embed_points(coords, labels, pad=boxes is None)], dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            eh, ew = self.image_embedding_size
            dense = self.no_mask_embed.weight[0].reshape(1, 1, 1, -1).expand(
                bs, eh, ew, self.embed_dim)
        return sparse, dense
