"""The nerfacto radiance field and the proposal density field,
counterpart of ``samnerf_tpu/fields/nerfacto_field.py``.

The MLPs are pointwise, so points go to the encoders in their natural
[R*S] order (the JAX package's sample-major reorder only serves the TPU
scan).  The same code serves and trains: gradients reach the MLPs and,
through F32-ENC-BWD, the f32 hash tables; positions carry none.
Appearance embeddings (off in both presets), occupancy culling and the
fused encode+MLP kernel wait.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.contraction import contract_to_unit
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.fields.mlp import MLP, trunc_exp
from samnerf_tpu_torch.ops.encodings import sh_encoding


def _contract_and_select(positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contraction to [0, 1]^3 and the in-unit-cube selector; points
    outside are moved to the origin."""
    p = contract_to_unit(positions)
    selector = ((p > 0.0) & (p < 1.0)).all(dim=-1)
    return p * selector[..., None], selector


class NerfactoField(nn.Module):
    """Density + view-dependent color field."""

    def __init__(self, num_layers: int = 2, hidden_dim: int = 64,
                 geo_feat_dim: int = 15, num_levels: int = 16,
                 max_res: int = 2048, log2_hashmap_size: int = 19,
                 num_layers_color: int = 3, hidden_dim_color: int = 64,
                 hash_q8: bool = False, hash_fn: str = "reference",
                 quant_bits: int = 8, device="cuda"):
        super().__init__()
        self.encoding = ParityHashEncoding(
            num_levels=num_levels, min_res=16, max_res=max_res,
            log2_hashmap_size=log2_hashmap_size, features_per_level=2,
            quantize_serve=hash_q8, quant_bits=quant_bits, hash_fn=hash_fn,
            device=device)
        self.mlp_base = MLP(self.encoding.out_dim, hidden_dim, num_layers - 1,
                            1 + geo_feat_dim, device=device)
        self.mlp_head = MLP(16 + geo_feat_dim, hidden_dim_color,
                            num_layers_color - 1, 3,
                            output_activation=torch.sigmoid, device=device)

    def get_density(self, positions: torch.Tensor):
        """[R, S, 3] -> (density [R, S, 1], geo_feat [R, S, geo])."""
        p, selector = _contract_and_select(positions)
        h = self.mlp_base(self.encoding(p.reshape(-1, 3)))
        h = h.reshape(*positions.shape[:-1], h.shape[-1])
        return trunc_exp(h[..., :1]) * selector[..., None], h[..., 1:]

    def forward(self, positions: torch.Tensor, directions: torch.Tensor) -> dict:
        """positions [R, S, 3], directions [R, 3] -> density, rgb."""
        density, geo = self.get_density(positions)
        d_enc = sh_encoding(directions)[..., None, :].expand(
            *positions.shape[:-1], 16)
        rgb = self.mlp_head(torch.cat([d_enc, geo], dim=-1))
        return {"density": density, "rgb": rgb}


class HashMLPDensityField(nn.Module):
    """Proposal density field."""

    def __init__(self, num_layers: int = 2, hidden_dim: int = 16,
                 num_levels: int = 5, max_res: int = 128, base_res: int = 16,
                 log2_hashmap_size: int = 13, features_per_level: int = 2,
                 hash_q8: bool = False, hash_fn: str = "reference",
                 quant_bits: int = 8, device="cuda"):
        super().__init__()
        self.encoding = ParityHashEncoding(
            num_levels=num_levels, min_res=base_res, max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level, quantize_serve=hash_q8,
            quant_bits=quant_bits, hash_fn=hash_fn, device=device)
        self.mlp = MLP(self.encoding.out_dim, hidden_dim, num_layers - 1, 1,
                       device=device)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """[R, S, 3] -> density [R, S, 1]."""
        p, selector = _contract_and_select(positions)
        raw = self.mlp(self.encoding(p.reshape(-1, 3)))
        raw = raw.reshape(*positions.shape[:-1], 1)
        return trunc_exp(raw) * selector[..., None]
