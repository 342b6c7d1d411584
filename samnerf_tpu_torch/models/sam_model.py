"""SAMModel eval forward: proposal sampling, nerfacto field, volume
rendering, top-k sharpened samples and the SAM / ClipSeg feature render.

Counterpart of ``samnerf_tpu/models/sam_model.py`` (``SAMModelConfig``,
``SAMModel.__call__(train=False)``, ``features_from_topk``).  Training,
losses, early termination and occupancy culling wait.  The state dict
names follow the flax tree (see :mod:`samnerf_tpu_torch.convert`):
``fields``, ``proposal_networks.i``, ``sam_field``, ``conv``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.nerfacto_field import HashMLPDensityField, NerfactoField
from samnerf_tpu_torch.fields.sam_field import ConvHead, SAMField
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.samplers import proposal_sampling
from samnerf_tpu_torch.utils.init import init_state


@dataclasses.dataclass(frozen=True)
class SAMModelConfig:
    """The serve-path fields of the JAX ``SAMModelConfig``, same defaults."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    num_proposal_samples_per_ray: Tuple[int, ...] = (64,)
    num_nerf_samples_per_ray: int = 32
    proposal_net_args: Tuple[Dict[str, Any], ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    distill_sam: bool = True
    use_clipseg_feature: bool = True
    num_sam_samples: int = 16
    sharpening_temperature: float = 10.0
    hidden_layers: int = 1
    hashgrid_layers: Tuple[int, ...] = (12, 12)
    hashgrid_resolutions: Tuple[Tuple[int, int], ...] = ((16, 128), (128, 512))
    hashgrid_sizes: Tuple[int, ...] = (19, 19)
    patch_size: int = 4
    kernel_size: int = 3
    hash_q8_serve: bool = False
    serve_quant_bits: int = 8
    serve_quant_bits_props: int = 0
    serve_quant_bits_sam: int = 0
    hash_fn: str = "reference"

    @property
    def num_proposal_iterations(self) -> int:
        return len(self.num_proposal_samples_per_ray)


class SAMModel(nn.Module):
    """Eval forward: RayBundle -> outputs dict.  Parameters are allocated
    uninitialised on ``device``; load a state from :func:`init_params` or
    :func:`samnerf_tpu_torch.convert.params_from_jax`."""

    def __init__(self, config: SAMModelConfig, device="cuda"):
        super().__init__()
        cfg = self.config = config
        self.fields = NerfactoField(
            hidden_dim=cfg.hidden_dim, hidden_dim_color=cfg.hidden_dim_color,
            num_levels=cfg.num_levels, max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size, hash_q8=cfg.hash_q8_serve,
            hash_fn=cfg.hash_fn, quant_bits=cfg.serve_quant_bits, device=device)
        args = cfg.proposal_net_args
        self.proposal_networks = nn.ModuleList(
            HashMLPDensityField(
                hash_q8=cfg.hash_q8_serve, hash_fn=cfg.hash_fn,
                quant_bits=cfg.serve_quant_bits_props or cfg.serve_quant_bits,
                device=device, **args[min(i, len(args) - 1)])
            for i in range(cfg.num_proposal_iterations))
        if cfg.distill_sam:
            self.sam_field = SAMField(
                grid_layers=cfg.hashgrid_layers, grid_sizes=cfg.hashgrid_sizes,
                grid_resolutions=cfg.hashgrid_resolutions,
                hidden_layers=cfg.hidden_layers,
                use_clipseg=cfg.use_clipseg_feature, hash_q8=cfg.hash_q8_serve,
                hash_fn=cfg.hash_fn,
                quant_bits=cfg.serve_quant_bits_sam or cfg.serve_quant_bits,
                device=device)
            self.conv = ConvHead(kernel_size=cfg.kernel_size, device=device)

    @torch.no_grad()
    def forward(self, ray_bundle: RayBundle, get_features: Sequence[str] = (),
                bg_color: Optional[torch.Tensor] = None,
                return_topk: bool = False) -> Dict[str, Any]:
        """Render a flat bundle of rays (eval mode).

        ``get_features`` is a subset of ("sam", "clipseg"); with "sam" and
        ``patch_size > 1`` rays arrive patch-major.  ``return_topk`` also
        emits the per-ray top-k sharpened weights ``topk_w`` [R, K, 1] and
        euclidean sample mids ``topk_mid`` [R, K] for the fused feature
        pass of :mod:`samnerf_tpu_torch.engine.eval_render`."""
        cfg = self.config
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = ray_bundle.with_near_far(cfg.near_plane, cfg.far_plane)
        ray_samples, weights_list, ray_samples_list = proposal_sampling(
            ray_bundle, list(self.proposal_networks),
            cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray)
        field_out = self.fields(ray_samples.positions(), ray_samples.directions)
        weights = ray_samples.get_weights(field_out["density"])
        if bg_color is not None:
            rgb = render_ops.render_rgb(field_out["rgb"], weights,
                                        background_color="explicit", bg_rgb=bg_color)
        else:
            rgb = render_ops.render_rgb(field_out["rgb"], weights,
                                        background_color=cfg.background_color)
        outputs: Dict[str, Any] = {
            "rgb": rgb,
            "accumulation": render_ops.render_accumulation(weights),
            "depth": render_ops.render_depth_median(weights, ray_samples),
        }
        for i in range(cfg.num_proposal_iterations):
            outputs[f"prop_depth_{i}"] = render_ops.render_depth_median(
                weights_list[i], ray_samples_list[i])

        if cfg.distill_sam and (len(get_features) > 0 or return_topk):
            sam_weights, best_ids = render_ops.topk_sharpened_weights(
                weights, cfg.num_sam_samples, cfg.sharpening_temperature)
            sam_samples = ray_samples.take_topk(best_ids)
            if return_topk:
                outputs["topk_w"] = sam_weights
                outputs["topk_mid"] = ((sam_samples.starts + sam_samples.ends)
                                       * 0.5)[..., 0]
            if len(get_features) > 0:
                outputs.update(self.features_from_topk(
                    sam_samples.positions(), sam_weights, tuple(get_features),
                    cull=True))
        return outputs

    @torch.no_grad()
    def features_from_topk(self, positions: torch.Tensor, weights: torch.Tensor,
                           get_features: Sequence[str],
                           cull: bool = False) -> Dict[str, Any]:
        """SAM / ClipSeg field at pre-selected top-k samples: positions
        [R, K, 3], sharpened weights [R, K, 1] -> weighted means, the SAM
        one through the patch conv head.  ``cull``: zero-weight samples
        take the sentinel position (exact; see ``SAMField``)."""
        cfg = self.config
        out: Dict[str, Any] = {}
        live = (weights > 0.0).float() if cull else None
        feats = self.sam_field(positions, tuple(get_features), live)
        if "sam" in feats:
            sam_render = render_ops.render_mean(feats["sam"], weights)
            if cfg.patch_size > 1:
                ps = cfg.patch_size
                out["sam"] = self.conv(
                    sam_render.reshape(-1, ps, ps, sam_render.shape[-1]))
            else:
                out["sam"] = sam_render
        if "clipseg" in feats:
            out["clipseg"] = render_ops.render_mean(feats["clipseg"], weights)
        return out


def init_params(config: SAMModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded state for ``SAMModel(config)``: hash tables U(-1e-4, 1e-4)
    (the tcnn and JAX default), dense and conv weights lecun-normal,
    biases zero."""
    return init_state(SAMModel(config, device="meta"), generator, device)
