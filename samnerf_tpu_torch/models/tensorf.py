"""TensoRF (VM decomposition), counterpart of ``samnerf_tpu/models/tensorf.py``:
density and colour grids factorized into 3 planes and 3 lines each
(16 and 48 components at 128^2 / 128), a basis matrix to 27 appearance
features and a 128-wide colour head over them and the direction's
2-frequency encoding; 200 stratified samples in the scene box, 50 PDF
samples from their weights, a white background, and an L1 sparsity term
on the density factors.  The coarse density only places the PDF samples,
whose bins carry no gradient, so the port evaluates it without autograd:
the gradients are the JAX model's."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.mlp import MLP
from samnerf_tpu_torch.models.vanilla_nerf import collide
from samnerf_tpu_torch.models.zoo_base import ZooModel
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.encodings import nerf_frequency_encoding, tensor_vm_encode
from samnerf_tpu_torch.ops.samplers import initial_samples, pdf_samples, spacing_linear
from samnerf_tpu_torch.utils.dtypes import sigmoid
from samnerf_tpu_torch.utils.init import init_state


@dataclasses.dataclass(frozen=True)
class TensoRFConfig:
    num_uniform_samples: int = 200
    num_samples: int = 50
    near_plane: float = 0.05
    far_plane: float = 1000.0
    resolution: int = 128
    density_components: int = 16
    color_components: int = 48
    appearance_dim: int = 27
    aabb_scale: float = 1.5
    background_color: str = "white"
    l1_weight: float = 8e-5


FACTORS = ("density_planes", "density_lines", "color_planes", "color_lines")
FACTOR_STD = 0.1
"""The factors' initial N(0, 0.1^2), the JAX field's ``normal(0.1)``."""


class TensoRFField(nn.Module):
    def __init__(self, resolution: int = 128, density_components: int = 16,
                 color_components: int = 48, appearance_dim: int = 27,
                 aabb_scale: float = 1.5, device="cuda"):
        super().__init__()
        r = resolution
        self.aabb_scale = aabb_scale
        self.density_planes = nn.Parameter(torch.empty((3, r, r, density_components),
                                                       device=device))
        self.density_lines = nn.Parameter(torch.empty((3, r, density_components),
                                                      device=device))
        self.color_planes = nn.Parameter(torch.empty((3, r, r, color_components),
                                                     device=device))
        self.color_lines = nn.Parameter(torch.empty((3, r, color_components), device=device))
        self.basis_mat = nn.Linear(3 * color_components, appearance_dim, bias=False,
                                   device=device)
        self.color_head = MLP(appearance_dim + 12, 128, 1, 3, output_activation=sigmoid,
                              device=device)

    def _normalize(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.aabb_scale
        p = (positions + s) / (2 * s)
        sel = ((p > 0.0) & (p < 1.0)).all(dim=-1)
        return torch.clamp(p, 0.0, 1.0), sel

    def get_density(self, positions: torch.Tensor) -> torch.Tensor:
        """[R, S, 3] -> [R, S, 1]; zero outside the box."""
        p, sel = self._normalize(positions)
        feats = tensor_vm_encode(self.density_planes, self.density_lines, p.reshape(-1, 3))
        density = torch.relu(torch.sum(feats, dim=-1))
        return (density.reshape(positions.shape[:-1]) * sel)[..., None]

    def get_color(self, positions: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
        p, _ = self._normalize(positions)
        flat = p.reshape(-1, 3)
        feats = self.basis_mat(tensor_vm_encode(self.color_planes, self.color_lines, flat))
        d_enc = nerf_frequency_encoding(directions, 2)
        d_enc = d_enc[..., None, :].expand(*positions.shape[:-1], d_enc.shape[-1])
        rgb = self.color_head(torch.cat([feats, d_enc.reshape(flat.shape[0], -1)], dim=-1))
        return rgb.reshape(*positions.shape[:-1], 3)

    def forward(self, positions: torch.Tensor, directions: torch.Tensor):
        return {"density": self.get_density(positions),
                "rgb": self.get_color(positions, directions)}


class TensoRFModel(ZooModel):
    shared_jitter = True

    def __init__(self, config: TensoRFConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.jitter_levels = (config.num_uniform_samples, config.num_samples)
        self.field = TensoRFField(resolution=config.resolution,
                                  density_components=config.density_components,
                                  color_components=config.color_components,
                                  appearance_dim=config.appearance_dim,
                                  aabb_scale=config.aabb_scale, device=device)

    def render(self, ray_bundle: RayBundle, train: bool,
               jitter: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        cfg = self.config
        jc, jf = jitter if jitter is not None else (None, None)
        rb = collide(ray_bundle, cfg.aabb_scale, cfg.near_plane, cfg.far_plane)
        coarse = initial_samples(rb, cfg.num_uniform_samples, jc,
                                 spacing_fn=spacing_linear, spacing_inv=spacing_linear)
        with torch.no_grad():
            w_c = coarse.get_weights(self.field.get_density(coarse.positions()))
        fine = pdf_samples(rb, coarse, w_c, cfg.num_samples, jf,
                           spacing_inv=spacing_linear)
        out = self.field(fine.positions(), fine.directions)
        weights = fine.get_weights(out["density"])
        return {"rgb": render_ops.render_rgb(out["rgb"], weights, cfg.background_color,
                                             training=train),
                "accumulation": render_ops.render_accumulation(weights),
                "depth": render_ops.render_depth_expected(weights, fine)}

    def init_params(self, generator: torch.Generator, device="cuda") -> Dict[str, torch.Tensor]:
        """:func:`init_state`, with the factors N(0, 0.1^2)."""
        state = init_state(self, generator, device)
        for name in FACTORS:
            key = f"field.{name}"
            state[key] = (torch.randn(state[key].shape, generator=generator,
                                      device=generator.device) * FACTOR_STD).to(device)
        return state


def get_loss_dict(config: TensoRFConfig, model: TensoRFModel,
                  outputs: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The rgb loss and the L1 term, which reads the model's density
    factors (the JAX loss reads them from the parameter tree)."""
    losses = {"rgb_loss": torch.mean((outputs["rgb"] - batch["image"]) ** 2)}
    if config.l1_weight > 0:
        field = model.field
        l1 = field.density_planes.abs().mean() + field.density_lines.abs().mean()
        losses["l1_reg"] = config.l1_weight * l1
    return losses
