"""SAM: the ViT image encoder, prompt encoder and mask decoder, and the
mask postprocess.

Counterpart of ``samnerf_tpu/perception/sam/sam.py``.  The image encoder
is optional: the serve path decodes masks on an embedding rendered by the
NeRF and builds ``Sam()`` without one.  Module names are the reference
torch SAM's (``image_encoder.*``, ``prompt_encoder.*``,
``mask_decoder.*``).  Images are NHWC.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.mask_decoder import MaskDecoder
from samnerf_tpu_torch.perception.sam.prompt_encoder import PromptEncoder
from samnerf_tpu_torch.utils.init import init_state

PROMPT_EMBED_DIM = 256
IMAGE_SIZE = 1024
EMBED_SIZE = 64
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class Sam(nn.Module):
    """Prompt encoder + mask decoder at the widths every SAM variant
    shares (vit_b/l/h differ only in the image encoder); the prompt
    encoder's sizes follow the image encoder's ``img_size`` when there is
    one.  ``compute_dtype`` reaches the mask decoder's two-way transformer
    (the prompt encoder accepts and ignores it, as in the JAX package)."""

    mask_threshold = 0.0

    def __init__(self, image_encoder: Optional[ImageEncoderViT] = None,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.image_encoder = image_encoder
        self.img_size = image_encoder.img_size if image_encoder else IMAGE_SIZE
        embed = image_encoder.embed_size if image_encoder else EMBED_SIZE
        self.prompt_encoder = PromptEncoder(
            embed_dim=PROMPT_EMBED_DIM, image_embedding_size=(embed, embed),
            input_image_size=(self.img_size, self.img_size), mask_in_chans=16,
            compute_dtype=compute_dtype, device=device)
        self.mask_decoder = MaskDecoder(transformer_dim=PROMPT_EMBED_DIM,
                                        num_multimask_outputs=3,
                                        iou_head_depth=3, iou_head_hidden_dim=256,
                                        compute_dtype=compute_dtype, device=device)

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise and zero-pad to the encoder's square. x: [B, h, w, 3]."""
        mean = torch.tensor(PIXEL_MEAN, device=x.device)
        std = torch.tensor(PIXEL_STD, device=x.device)
        x = (x - mean) / std
        return F.pad(x, (0, 0, 0, self.img_size - x.shape[2],
                         0, self.img_size - x.shape[1]))

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed NHWC image -> [B, 64, 64, 256]."""
        return self.image_encoder(x)

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

    def forward(self, image: torch.Tensor, points=None, boxes=None,
                mask_input=None, multimask_output: bool = True):
        """NHWC image [B, h, w, 3] in 0..255 -> (low-res masks, iou)."""
        feats = self.encode_image(self.preprocess(image))
        return self.decode_masks(feats, points, boxes, mask_input, multimask_output)


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
    """A seeded state for ``Sam()``, the decoder only (rules of
    ``utils.init.init_state``)."""
    return init_state(Sam(device="meta"), generator, device)
