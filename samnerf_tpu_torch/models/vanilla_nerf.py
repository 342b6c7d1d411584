"""Vanilla NeRF (coarse + fine), counterpart of
``samnerf_tpu/models/vanilla_nerf.py``: frequency encodings (10 position,
4 direction), an 8 x 256 trunk with a skip, separate coarse and fine
fields, 64 stratified samples in the scene box plus 128 PDF samples merged
with them, a white background.  As in the JAX model, rays are clipped to
the box [-aabb_scale, aabb_scale]^3 by the AABB collider and sampled
linearly; one jitter draw serves both levels."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.mlp import MLP, trunc_exp
from samnerf_tpu_torch.models.zoo_base import ZooModel
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.colliders import aabb_collider
from samnerf_tpu_torch.ops.encodings import nerf_frequency_encoding
from samnerf_tpu_torch.ops.samplers import initial_samples, pdf_samples, spacing_linear
from samnerf_tpu_torch.utils.dtypes import sigmoid


@dataclasses.dataclass(frozen=True)
class VanillaNerfConfig:
    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    near_plane: float = 0.05
    aabb_scale: float = 1.5
    far_plane: float = 1000.0
    pos_frequencies: int = 10
    dir_frequencies: int = 4
    hidden_dim: int = 256
    background_color: str = "white"


class NeRFField(nn.Module):
    """Two 4-layer ReLU trunks (the second re-reads the position
    encoding), a density head with ``trunc_exp`` and a direction-conditioned
    colour head."""

    def __init__(self, pos_frequencies: int = 10, dir_frequencies: int = 4,
                 hidden_dim: int = 256, device="cuda"):
        super().__init__()
        self.pos_frequencies = pos_frequencies
        self.dir_frequencies = dir_frequencies
        p_dim = 3 * 2 * pos_frequencies
        d_dim = 3 * 2 * dir_frequencies
        self.trunk_a = MLP(p_dim, hidden_dim, 3, hidden_dim,
                           output_activation=torch.relu, device=device)
        self.trunk_b = MLP(hidden_dim + p_dim, hidden_dim, 3, hidden_dim,
                           output_activation=torch.relu, device=device)
        self.density = nn.Linear(hidden_dim, 1, device=device)
        self.color = MLP(hidden_dim + d_dim, hidden_dim // 2, 0, 3,
                         output_activation=sigmoid, device=device)

    def heads(self, p_enc: torch.Tensor, directions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Encoded positions [R, S, P], directions [R, 3] -> density, rgb."""
        d_enc = nerf_frequency_encoding(directions, self.dir_frequencies)
        d_enc = d_enc[..., None, :].expand(*p_enc.shape[:-1], d_enc.shape[-1])
        h = self.trunk_a(p_enc)
        h = self.trunk_b(torch.cat([h, p_enc], dim=-1))
        density = trunc_exp(self.density(h))
        rgb = self.color(torch.cat([h, d_enc], dim=-1))
        return {"density": density, "rgb": rgb}

    def forward(self, positions: torch.Tensor, directions: torch.Tensor):
        return self.heads(nerf_frequency_encoding(positions, self.pos_frequencies),
                          directions)


def collide(ray_bundle: RayBundle, aabb_scale: float, near_plane: float,
            far_plane: float) -> RayBundle:
    """The box collider of the linear-spacing zoo models, far capped at
    ``far_plane``."""
    s = aabb_scale
    aabb = torch.tensor([[-s] * 3, [s] * 3], dtype=torch.float32,
                        device=ray_bundle.origins.device)
    rb = aabb_collider(ray_bundle, aabb, near_plane=near_plane)
    return dataclasses.replace(rb, fars=torch.clamp_max(rb.fars, far_plane))


def coarse_fine_outputs(rgb_c, w_c, rgb_f, w_f, fine, background: str,
                        train: bool) -> Dict[str, Any]:
    rgb_fine = render_ops.render_rgb(rgb_f, w_f, background, training=train)
    return {"rgb_coarse": render_ops.render_rgb(rgb_c, w_c, background, training=train),
            "rgb_fine": rgb_fine, "rgb": rgb_fine,
            "accumulation": render_ops.render_accumulation(w_f),
            "depth": render_ops.render_depth_expected(w_f, fine)}


class VanillaNerfModel(ZooModel):
    shared_jitter = True

    def __init__(self, config: VanillaNerfConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.jitter_levels = (config.num_coarse_samples, config.num_importance_samples)
        kw = dict(pos_frequencies=config.pos_frequencies,
                  dir_frequencies=config.dir_frequencies, hidden_dim=config.hidden_dim,
                  device=device)
        self.field_coarse = NeRFField(**kw)
        self.field_fine = NeRFField(**kw)

    def render(self, ray_bundle: RayBundle, train: bool,
               jitter: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        cfg = self.config
        jc, jf = jitter if jitter is not None else (None, None)
        rb = collide(ray_bundle, cfg.aabb_scale, cfg.near_plane, cfg.far_plane)
        coarse = initial_samples(rb, cfg.num_coarse_samples, jc,
                                 spacing_fn=spacing_linear, spacing_inv=spacing_linear)
        out_c = self.field_coarse(coarse.positions(), coarse.directions)
        w_c = coarse.get_weights(out_c["density"])
        fine = pdf_samples(rb, coarse, w_c, cfg.num_importance_samples, jf,
                           include_original=True, spacing_inv=spacing_linear)
        out_f = self.field_fine(fine.positions(), fine.directions)
        w_f = fine.get_weights(out_f["density"])
        return coarse_fine_outputs(out_c["rgb"], w_c, out_f["rgb"], w_f, fine,
                                   cfg.background_color, train)


def get_loss_dict(outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    img = batch["image"]
    return {"rgb_loss_coarse": torch.mean((outputs["rgb_coarse"] - img) ** 2),
            "rgb_loss_fine": torch.mean((outputs["rgb_fine"] - img) ** 2)}
