"""SAM mask decoder, counterpart of
``samnerf_tpu/perception/sam/mask_decoder.py`` (reference torch names:
``output_upscaling`` holds torch ``ConvTranspose2d`` weights as the
reference checkpoint stores them)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from samnerf_tpu_torch.perception.sam.common import LayerNorm2d
from samnerf_tpu_torch.perception.sam.transformer import TwoWayTransformer


class MLP(nn.Module):

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, sigmoid_output: bool = False, device="cuda"):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class MaskDecoder(nn.Module):

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 device="cuda"):
        super().__init__()
        d = transformer_dim
        self.transformer = TwoWayTransformer(depth=2, embedding_dim=d,
                                             mlp_dim=2048, num_heads=8,
                                             device=device)
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d, device=device)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d, device=device)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, kernel_size=2, stride=2, device=device),
            LayerNorm2d(d // 4, device=device), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, kernel_size=2, stride=2,
                               device=device),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3, device=device)
            for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim,
                                       self.num_mask_tokens, iou_head_depth,
                                       device=device)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor, multimask_output: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeddings / image_pe [1, h, w, C], sparse [B, N, C], dense
        [B, h, w, C] -> (masks [B, k, 4h, 4w], iou_pred [B, k])."""
        masks, iou_pred = self.predict_masks(
            image_embeddings, image_pe, sparse_prompt_embeddings,
            dense_prompt_embeddings)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl]

    def predict_masks(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                      dense_prompt_embeddings):
        bs = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        output_tokens = output_tokens[None].expand(bs, *output_tokens.shape)
        tokens = torch.cat([output_tokens, sparse_prompt_embeddings], dim=1)
        src = torch.repeat_interleave(image_embeddings, bs, dim=0) \
            + dense_prompt_embeddings
        pos_src = torch.repeat_interleave(image_pe, bs, dim=0)
        b, h, w, c = src.shape

        hs, src = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        up = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i, :])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper_in, up)
        return masks, self.iou_prediction_head(iou_token_out)
