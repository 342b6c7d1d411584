"""Mip-NeRF, counterpart of ``samnerf_tpu/models/mipnerf.py``: one field
shared by both levels, read through the integrated positional encoding
of each sample's conical frustum (16 frequencies), 128 stratified
samples in the scene box plus 128 PDF samples merged with them, a white
background; the coarse loss weighs 0.1."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from samnerf_tpu_torch.core.rays import RayBundle, RaySamples
from samnerf_tpu_torch.models.vanilla_nerf import NeRFField, coarse_fine_outputs, collide
from samnerf_tpu_torch.models.zoo_base import ZooModel
from samnerf_tpu_torch.ops.encodings import conical_frustum_to_gaussian, integrated_pos_enc
from samnerf_tpu_torch.ops.samplers import initial_samples, pdf_samples, spacing_linear


@dataclasses.dataclass(frozen=True)
class MipNerfConfig:
    num_coarse_samples: int = 128
    num_importance_samples: int = 128
    near_plane: float = 0.05
    aabb_scale: float = 1.5
    far_plane: float = 1000.0
    pos_frequencies: int = 16
    dir_frequencies: int = 4
    hidden_dim: int = 256
    background_color: str = "white"


class MipNerfField(NeRFField):
    """NeRF's trunks and heads over the integrated encoding of samples."""

    def forward(self, ray_samples: RaySamples):
        mean, cov = conical_frustum_to_gaussian(ray_samples)
        return self.heads(integrated_pos_enc(mean, cov, self.pos_frequencies),
                          ray_samples.directions)


class MipNerfModel(ZooModel):
    shared_jitter = True

    def __init__(self, config: MipNerfConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.jitter_levels = (config.num_coarse_samples, config.num_importance_samples)
        self.field = MipNerfField(pos_frequencies=config.pos_frequencies,
                                  dir_frequencies=config.dir_frequencies,
                                  hidden_dim=config.hidden_dim, device=device)

    def render(self, ray_bundle: RayBundle, train: bool,
               jitter: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        cfg = self.config
        jc, jf = jitter if jitter is not None else (None, None)
        rb = collide(ray_bundle, cfg.aabb_scale, cfg.near_plane, cfg.far_plane)
        coarse = initial_samples(rb, cfg.num_coarse_samples, jc,
                                 spacing_fn=spacing_linear, spacing_inv=spacing_linear)
        out_c = self.field(coarse)
        w_c = coarse.get_weights(out_c["density"])
        fine = pdf_samples(rb, coarse, w_c, cfg.num_importance_samples, jf,
                           include_original=True, spacing_inv=spacing_linear)
        out_f = self.field(fine)
        w_f = fine.get_weights(out_f["density"])
        return coarse_fine_outputs(out_c["rgb"], w_c, out_f["rgb"], w_f, fine,
                                   cfg.background_color, train)


def get_loss_dict(outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    img = batch["image"]
    return {"rgb_loss_coarse": 0.1 * torch.mean((outputs["rgb_coarse"] - img) ** 2),
            "rgb_loss_fine": torch.mean((outputs["rgb_fine"] - img) ** 2)}
