"""Decoder-only SAM: prompt encoder + mask decoder on a given embedding,
and the mask postprocess.

Counterpart of ``samnerf_tpu/perception/sam/sam.py`` for the serve path,
where the embedding is rendered by the NeRF and the ViT image encoder
never runs (it waits, with its flash-attention kernel).  Module names are
the reference torch SAM's (``prompt_encoder.*``, ``mask_decoder.*``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samnerf_tpu_torch.perception.sam.mask_decoder import MaskDecoder
from samnerf_tpu_torch.perception.sam.prompt_encoder import PromptEncoder
from samnerf_tpu_torch.utils.init import init_state

PROMPT_EMBED_DIM = 256
IMAGE_SIZE = 1024
EMBED_SIZE = 64


class Sam(nn.Module):
    """Prompt encoder + mask decoder at the widths every SAM variant
    shares (vit_b/l/h differ only in the image encoder)."""

    mask_threshold = 0.0
    img_size = IMAGE_SIZE

    def __init__(self, device="cuda"):
        super().__init__()
        self.prompt_encoder = PromptEncoder(
            embed_dim=PROMPT_EMBED_DIM,
            image_embedding_size=(EMBED_SIZE, EMBED_SIZE),
            input_image_size=(IMAGE_SIZE, IMAGE_SIZE), mask_in_chans=16,
            device=device)
        self.mask_decoder = MaskDecoder(transformer_dim=PROMPT_EMBED_DIM,
                                        num_multimask_outputs=3,
                                        iou_head_depth=3, iou_head_hidden_dim=256,
                                        device=device)

    def get_dense_pe(self) -> torch.Tensor:
        return self.prompt_encoder.get_dense_pe()

    @torch.no_grad()
    def decode_masks(self, features: torch.Tensor, points=None, boxes=None,
                     mask_input=None, multimask_output: bool = True):
        """features [B, 64, 64, 256] NHWC -> (low-res masks [B, k, 256, 256],
        iou [B, k]).  Points padded with label -1 take the not-a-point
        embedding, as in the reference."""
        sparse, dense = self.prompt_encoder(points=points, boxes=boxes,
                                            masks=mask_input)
        return self.mask_decoder(
            image_embeddings=features, image_pe=self.get_dense_pe(),
            sparse_prompt_embeddings=sparse, dense_prompt_embeddings=dense,
            multimask_output=multimask_output)


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int],
                      img_size: int = IMAGE_SIZE) -> torch.Tensor:
    """Bilinear upscale to ``img_size``, unpad, bilinear resize to the
    original size (align_corners=False, no antialiasing)."""
    m = F.interpolate(masks, (img_size, img_size), mode="bilinear",
                      align_corners=False)
    m = m[..., :input_size[0], :input_size[1]]
    return F.interpolate(m, original_size, mode="bilinear", align_corners=False)


def init_decoder_params(generator: torch.Generator,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded state for ``Sam()`` (rules of ``utils.init.init_state``)."""
    return init_state(Sam(device="meta"), generator, device)
