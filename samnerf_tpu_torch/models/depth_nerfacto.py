"""Depth-supervised nerfacto, counterpart of ``samnerf_tpu/models/depth_nerfacto.py``:
the port's ``SAMModel`` with the feature branch off as the nerfacto
backbone, plus a DS-NeRF or URF depth term on the nerf level's weights
and samples against ``batch["depth_image"]`` [R, 1]."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from samnerf_tpu_torch.models import sam_model as nerfacto
from samnerf_tpu_torch.ops import losses as loss_ops


@dataclasses.dataclass(frozen=True)
class DepthNerfactoConfig:
    depth_loss_mult: float = 1e-3
    depth_loss_type: str = "ds_nerf"  # or "urf"
    depth_sigma: float = 0.01
    base: nerfacto.SAMModelConfig = dataclasses.field(
        default_factory=lambda: nerfacto.SAMModelConfig(distill_sam=False))


class DepthNerfactoModel(nerfacto.SAMModel):
    """The nerfacto forward (feature branch off)."""


def get_loss_dict(config: DepthNerfactoConfig, outputs: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    losses = nerfacto.get_loss_dict(config.base, outputs, batch)
    if "depth_image" in batch:
        term = batch["depth_image"]
        weights = outputs["weights_list"][-1]
        rs = outputs["ray_samples_list"][-1]
        steps = (rs.starts + rs.ends) / 2.0
        if config.depth_loss_type == "ds_nerf":
            dl = loss_ops.ds_nerf_depth_loss(weights, term, steps, rs.deltas,
                                             config.depth_sigma)
        else:
            dl = loss_ops.urban_radiance_field_depth_loss(
                weights, term, outputs["depth"], steps, config.depth_sigma)
        losses["depth_loss"] = config.depth_loss_mult * dl
    return losses
