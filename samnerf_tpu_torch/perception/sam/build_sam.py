"""SAM model registry, counterpart of
``samnerf_tpu/perception/sam/build_sam.py``.

ViT-H (embed 1280 / depth 32 / heads 16 / global {7, 15, 23, 31}), ViT-L
(1024 / 24 / 16 / {5, 11, 17, 23}), ViT-B (768 / 12 / 12 / {2, 5, 8, 11});
common: prompt embed dim 256, image 1024, patch 16, window 14, rel-pos
on.  The port keeps the reference torch SAM's state-dict keys, so a
published ``sam_vit_*.pth`` loads with a strict ``load_state_dict`` and
no conversion.
"""
from __future__ import annotations

from typing import Optional

import torch

from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.sam import IMAGE_SIZE, PROMPT_EMBED_DIM, Sam

VIT_PATCH_SIZE = 16

_VIT_SPECS = {
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16,
                  global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11)),
}


def build_sam(model_type: str = "vit_h", checkpoint: Optional[str] = None,
              device="cuda", compute_dtype=torch.float32) -> Sam:
    """The SAM of ``model_type`` on ``device``: with a checkpoint (a
    reference-layout state dict, loaded strictly), else with PyTorch's
    default initialisation (or none, on the meta device).  ``compute_dtype``
    (``torch.bfloat16`` / ``"bfloat16"`` or f32) reaches the image encoder
    and the mask decoder's two-way transformer; parameters stay f32."""
    spec = _VIT_SPECS[model_type]
    build_on = "meta" if checkpoint is not None else device
    encoder = ImageEncoderViT(
        img_size=IMAGE_SIZE, patch_size=VIT_PATCH_SIZE, embed_dim=spec["embed_dim"],
        depth=spec["depth"], num_heads=spec["num_heads"], mlp_ratio=4.0,
        out_chans=PROMPT_EMBED_DIM, qkv_bias=True, use_rel_pos=True, window_size=14,
        global_attn_indexes=spec["global_attn_indexes"], compute_dtype=compute_dtype,
        device=build_on)
    sam = Sam(image_encoder=encoder, compute_dtype=compute_dtype, device=build_on)
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location=device, weights_only=True)
        sam.load_state_dict(state, strict=True, assign=True)
    return sam


def build_sam_vit_h(checkpoint=None, **kw) -> Sam:
    return build_sam("vit_h", checkpoint, **kw)


def build_sam_vit_l(checkpoint=None, **kw) -> Sam:
    return build_sam("vit_l", checkpoint, **kw)


def build_sam_vit_b(checkpoint=None, **kw) -> Sam:
    return build_sam("vit_b", checkpoint, **kw)


sam_model_registry = {
    "default": build_sam_vit_h,
    "vit_h": build_sam_vit_h,
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
}
