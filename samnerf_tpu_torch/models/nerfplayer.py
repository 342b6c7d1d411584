"""NerfPlayer (dynamic scenes), counterpart of ``samnerf_tpu/models/nerfplayer.py``:
a temporal hash field (:func:`samnerf_tpu_torch.ops.encodings.temporal_hash_encode`
on the flat table, 8 levels 16 -> 512, 2^19 rows, 16 time steps) over
contracted positions, 96 stratified samples per ray, the last sample as
background.  Rays without ``times`` render at t = 0.  With an occupancy
grid (nerfplayer-ngp) samples in empty cells of the box [-1, 1]^3 (or
``aabb``) get zero density."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from samnerf_tpu_torch.core.contraction import contract_to_unit
from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.mlp import MLP, trunc_exp
from samnerf_tpu_torch.models.zoo_base import ZooModel
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.encodings import (hash_grid_scalings, sh_encoding,
                                             temporal_hash_encode)
from samnerf_tpu_torch.ops.occupancy import occupancy_mask
from samnerf_tpu_torch.ops.samplers import initial_samples
from samnerf_tpu_torch.utils.dtypes import sigmoid


@dataclasses.dataclass(frozen=True)
class NerfPlayerConfig:
    num_samples: int = 96
    near_plane: float = 0.05
    far_plane: float = 1000.0
    num_levels: int = 8
    min_res: int = 16
    max_res: int = 512
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    num_time_steps: int = 16
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    background_color: str = "last_sample"


class TemporalField(nn.Module):
    def __init__(self, cfg: NerfPlayerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.scalings = tuple(hash_grid_scalings(cfg.num_levels, cfg.min_res,
                                                 cfg.max_res).tolist())
        self.table = nn.Parameter(torch.empty(
            (cfg.features_per_level, cfg.num_levels << cfg.log2_hashmap_size),
            device=device))
        self.mlp_base = MLP(cfg.num_levels * cfg.features_per_level, cfg.hidden_dim, 1,
                            1 + cfg.geo_feat_dim, device=device)
        self.mlp_head = MLP(16 + cfg.geo_feat_dim, cfg.hidden_dim, 2, 3,
                            output_activation=sigmoid, device=device)

    def _base(self, positions: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """positions [R, S, 3], times [R, 1] -> the base MLP's [R, S, 1+geo]."""
        c = self.cfg
        flat = contract_to_unit(positions).reshape(-1, 3)
        t_flat = times[..., None, :].expand(*positions.shape[:-1], 1).reshape(-1)
        enc = temporal_hash_encode(self.table, flat, t_flat, self.scalings,
                                   c.log2_hashmap_size, c.num_time_steps)
        return self.mlp_base(enc).reshape(*positions.shape[:-1], -1)

    def get_density(self, positions: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        return trunc_exp(self._base(positions, times)[..., :1])

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                times: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self._base(positions, times)
        density = trunc_exp(h[..., :1])
        d_enc = sh_encoding(directions)[..., None, :].expand(*positions.shape[:-1], 16)
        rgb = self.mlp_head(torch.cat([d_enc.reshape(-1, 16),
                                       h.reshape(-1, h.shape[-1])[..., 1:]], dim=-1))
        return {"density": density, "rgb": rgb.reshape(*positions.shape[:-1], 3)}


class NerfPlayerModel(ZooModel):
    def __init__(self, config: NerfPlayerConfig, device="cuda"):
        super().__init__()
        self.config = config
        self.jitter_levels = (config.num_samples,)
        self.field = TemporalField(config, device=device)

    def density_fn(self, positions: torch.Tensor,
                   times: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[N, 3] world positions -> [N, 1] density at ``times`` [N, 1]
        (t = 0 without): the grid update's query."""
        t = times if times is not None else positions.new_zeros((positions.shape[0], 1))
        return self.field.get_density(positions[:, None, :], t)[:, 0]

    def render(self, ray_bundle: RayBundle, train: bool,
               jitter: Optional[Sequence[torch.Tensor]] = None,
               occupancy: Optional[torch.Tensor] = None,
               aabb: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        cfg = self.config
        rb = ray_bundle.with_near_far(cfg.near_plane, cfg.far_plane)
        times = rb.times if rb.times is not None else torch.zeros_like(rb.origins[..., :1])
        samples = initial_samples(rb, cfg.num_samples, jitter[0] if jitter else None)
        pos = samples.positions()
        out = self.field(pos, samples.directions, times)
        density = out["density"]
        if occupancy is not None:
            box = aabb if aabb is not None else torch.tensor(
                [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device=pos.device)
            density = density * occupancy_mask(occupancy, pos, box)
        weights = samples.get_weights(density)
        return {"rgb": render_ops.render_rgb(out["rgb"], weights, cfg.background_color,
                                             training=train),
                "accumulation": render_ops.render_accumulation(weights),
                "depth": render_ops.render_depth_expected(weights, samples)}


def get_loss_dict(outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"rgb_loss": torch.mean((outputs["rgb"] - batch["image"]) ** 2)}
