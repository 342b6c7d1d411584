"""Instant-NGP, counterpart of ``samnerf_tpu/models/instant_ngp.py``: the
nerfacto field on one 16-level 2^19 hash pyramid (F32-ENC forward,
F32-ENC-BWD backward), 192 stratified samples per ray, and the training
occupancy grid (:func:`samnerf_tpu_torch.ops.occupancy.update_occupancy`)
multiplying the density of samples in empty cells to zero.  Training
composites over a random background per ray (``bg_rgb`` [R, 3], drawn
beside the jitter), eval over black."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.nerfacto_field import NerfactoField
from samnerf_tpu_torch.models.zoo_base import ZooModel
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.occupancy import occupancy_mask
from samnerf_tpu_torch.ops.samplers import initial_samples
from samnerf_tpu_torch.utils.misc import device_constant


@dataclasses.dataclass(frozen=True)
class InstantNGPConfig:
    num_samples: int = 192
    near_plane: float = 0.05
    far_plane: float = 1000.0
    grid_resolution: int = 128
    num_levels: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    aabb_scale: float = 1.0
    background_color: str = "random"


class InstantNGPModel(ZooModel):
    def __init__(self, config: InstantNGPConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.jitter_levels = (config.num_samples,)
        self.field = NerfactoField(num_levels=config.num_levels, max_res=config.max_res,
                                   log2_hashmap_size=config.log2_hashmap_size,
                                   use_appearance_embedding=False, device=device)

    @property
    def aabb(self) -> torch.Tensor:
        s = self.config.aabb_scale
        return device_constant([[-s, -s, -s], [s, s, s]], torch.float32,
                               self.field.encoding.table.device)

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        """[N, 3] world positions -> [N, 1] density (the grid update's query)."""
        density, _ = self.field.get_density(positions[:, None, :])
        return density[:, 0]

    def draw(self, num_rays: int, generator: torch.Generator, device) -> Dict[str, Any]:
        draws = super().draw(num_rays, generator, device)
        if self.config.background_color == "random":
            draws["bg_rgb"] = torch.rand((num_rays, 3), generator=generator, device=device)
        return draws

    def render(self, ray_bundle: RayBundle, train: bool,
               jitter: Optional[Sequence[torch.Tensor]] = None,
               bg_rgb: Optional[torch.Tensor] = None,
               occupancy: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        cfg = self.config
        rb = ray_bundle.with_near_far(cfg.near_plane, cfg.far_plane)
        samples = initial_samples(rb, cfg.num_samples, jitter[0] if jitter else None)
        positions = samples.positions()
        out = self.field(positions, samples.directions, train=train)
        density = out["density"]
        if occupancy is not None:
            density = density * occupancy_mask(occupancy, positions, self.aabb)
        weights = samples.get_weights(density)
        if cfg.background_color == "random":
            # the random background needs the step's draw; without one
            # (eval, or training without an rng in the JAX model) black
            if train and bg_rgb is not None:
                rgb = render_ops.render_rgb(out["rgb"], weights, "explicit",
                                            bg_rgb=bg_rgb, training=train)
            else:
                rgb = render_ops.render_rgb(out["rgb"], weights, "black", training=train)
        else:
            rgb = render_ops.render_rgb(out["rgb"], weights, cfg.background_color,
                                        training=train)
        return {"rgb": rgb, "accumulation": render_ops.render_accumulation(weights),
                "depth": render_ops.render_depth_expected(weights, samples)}


def get_loss_dict(outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"rgb_loss": torch.mean((outputs["rgb"] - batch["image"]) ** 2)}
