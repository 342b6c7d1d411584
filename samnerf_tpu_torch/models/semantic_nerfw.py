"""Semantic NeRF-W, counterpart of ``samnerf_tpu/models/semantic_nerfw.py``:
the nerfacto backbone (``SAMModel``, feature branch off) plus a semantic
head (64 wide, ``num_classes`` logits) on the geometry features of the
nerf level's samples, which training re-reads with a second
``get_density`` (one more F32-ENC and F32-ENC-BWD a step), rendered with
the backbone's weights detached and trained with cross-entropy.  Eval
returns the backbone's outputs without semantics, as the JAX model
does."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.mlp import MLP
from samnerf_tpu_torch.models import sam_model as nerfacto
from samnerf_tpu_torch.ops import rendering as render_ops

GEO_FEAT_DIM = 15
"""Width of the nerfacto field's geometry features."""


@dataclasses.dataclass(frozen=True)
class SemanticNerfWConfig:
    num_classes: int = 16
    semantic_loss_weight: float = 1.0
    base: nerfacto.SAMModelConfig = dataclasses.field(
        default_factory=lambda: nerfacto.SAMModelConfig(distill_sam=False))


class SemanticNerfWModel(nn.Module):
    def __init__(self, config: SemanticNerfWConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.backbone = nerfacto.SAMModel(config.base, device=device)
        self.semantic_head = MLP(GEO_FEAT_DIM, 64, 1, config.num_classes, device=device)

    def forward(self, ray_bundle: RayBundle, train: bool = False,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        """Training draws its jitter as ``SAMModel`` does (one tensor per
        level, or from ``generator``)."""
        outputs = self.backbone(ray_bundle, train=train, jitter=jitter, generator=generator)
        if not train:
            return outputs
        rs = outputs["ray_samples_list"][-1]
        weights = outputs["weights_list"][-1]
        _, geo = self.backbone.fields.get_density(rs.positions())
        logits = self.semantic_head(geo)
        outputs["semantics"] = render_ops.render_semantics(logits, weights.detach())
        return outputs


def get_loss_dict(config: SemanticNerfWConfig, outputs: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    losses = nerfacto.get_loss_dict(config.base, outputs, batch)
    if "semantics" in outputs and "semantics" in batch:
        labels = batch["semantics"].long()[..., 0]
        logp = torch.log_softmax(outputs["semantics"], dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])
        losses["semantics_loss"] = config.semantic_loss_weight * torch.mean(ce)
    return losses
