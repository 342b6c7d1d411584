"""SAMModel: proposal sampling, nerfacto field, volume rendering, top-k
sharpened samples and the SAM / DINO / ClipSeg feature render, with the
training losses and schedules.

Counterpart of ``samnerf_tpu/models/sam_model.py`` (``SAMModelConfig``,
``SAMModel.__call__``, ``features_from_topk``, ``get_loss_dict``,
``proposal_anneal_value``, ``proposal_grad_gate``), with serve-time
culling: an occupancy grid (``occupancy``, baked by
:func:`samnerf_tpu_torch.engine.eval_render.bake_occupancy`) in every
field, and early ray termination (``serve_transmittance_eps``).  The DINO
head (``use_dino_feature``, its loss ``dino_loss_weight``) and appearance
embeddings (``use_appearance_embedding`` over ``num_images`` training
images) are off in both presets.  ``use_remat`` and ``sort_points`` only
schedule the TPU and are left out: activations fit the card, and the
point sort is exact and order-restoring, so leaving it out changes no
result.  The
state dict names follow the flax tree (see :mod:`samnerf_tpu_torch.convert`):
``fields``, ``proposal_networks.i``, ``sam_field``, ``conv``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from samnerf_tpu_torch.core.rays import RayBundle, RaySamples
from samnerf_tpu_torch.fields.nerfacto_field import HashMLPDensityField, NerfactoField
from samnerf_tpu_torch.fields.sam_field import ConvHead, SAMField
from samnerf_tpu_torch.ops import losses as loss_ops
from samnerf_tpu_torch.ops import rendering as render_ops
from samnerf_tpu_torch.ops.occupancy import ServeOccupancy
from samnerf_tpu_torch.ops.samplers import proposal_sampling
from samnerf_tpu_torch.utils.dtypes import resolve_dtype
from samnerf_tpu_torch.utils.init import init_state


@dataclasses.dataclass(frozen=True)
class SAMModelConfig:
    """The fields of the JAX ``SAMModelConfig`` that serving and training
    read, same defaults."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    num_levels: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    use_appearance_embedding: bool = False
    num_proposal_samples_per_ray: Tuple[int, ...] = (64,)
    num_nerf_samples_per_ray: int = 32
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    proposal_net_args: Tuple[Dict[str, Any], ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    sam_loss_weight: float = 1.0
    dino_loss_weight: float = 1.0
    clipseg_loss_weight: float = 1.0
    distill_sam: bool = True
    use_dino_feature: bool = False
    use_clipseg_feature: bool = True
    num_sam_samples: int = 16
    sharpening_temperature: float = 10.0
    hidden_layers: int = 1
    hashgrid_layers: Tuple[int, ...] = (12, 12)
    hashgrid_resolutions: Tuple[Tuple[int, int], ...] = ((16, 128), (128, 512))
    hashgrid_sizes: Tuple[int, ...] = (19, 19)
    patch_size: int = 4
    kernel_size: int = 3
    occ_res: int = 96
    """Resolution of the serve-time occupancy grid in contracted unit
    space; it culls only when a grid is passed as ``occupancy``."""
    hash_q8_serve: bool = False
    serve_quant_bits: int = 8
    serve_quant_bits_props: int = 0
    serve_quant_bits_sam: int = 0
    serve_fuse_mlp: bool = False
    """Serve only: each hash encode and the MLP after it run as one
    FUSED-QMLP launch (``ops.hash_grid.parity_hash_encode_qmlp``).  Takes
    effect with ``hash_q8_serve``; the SAM field's heads fuse when their
    pyramids share a table size."""
    serve_transmittance_eps: float = 0.0
    """Early ray termination at eval (0 = off): nerf samples whose
    transmittance, estimated from the last proposal level's weights, is
    at most this are culled.  Training never culls."""
    hash_fn: str = "reference"
    num_images: int = 1
    """Training images, one appearance embedding each (``train.py`` sets
    it from the data)."""
    compute_dtype: Any = torch.float32
    """The type of every field MLP and the conv head (parameters stay
    f32): ``torch.float32`` / ``torch.bfloat16`` or the CLI's
    ``"float32"`` / ``"bfloat16"``, resolved to the torch dtype."""

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", resolve_dtype(self.compute_dtype))

    @property
    def num_proposal_iterations(self) -> int:
        return len(self.num_proposal_samples_per_ray)


class SAMModel(nn.Module):
    """RayBundle -> outputs dict.  Parameters are allocated uninitialised
    on ``device``; load a state from :func:`init_params` or
    :func:`samnerf_tpu_torch.convert.params_from_jax`."""

    def __init__(self, config: SAMModelConfig, device="cuda"):
        super().__init__()
        cfg = self.config = config
        self.fields = NerfactoField(
            hidden_dim=cfg.hidden_dim, hidden_dim_color=cfg.hidden_dim_color,
            num_levels=cfg.num_levels, max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size, hash_q8=cfg.hash_q8_serve,
            hash_fn=cfg.hash_fn, quant_bits=cfg.serve_quant_bits,
            fuse_mlp=cfg.serve_fuse_mlp, compute_dtype=cfg.compute_dtype,
            occ_res=cfg.occ_res, num_images=cfg.num_images,
            use_appearance_embedding=cfg.use_appearance_embedding, device=device)
        args = cfg.proposal_net_args
        self.proposal_networks = nn.ModuleList(
            HashMLPDensityField(
                hash_q8=cfg.hash_q8_serve, hash_fn=cfg.hash_fn,
                quant_bits=cfg.serve_quant_bits_props or cfg.serve_quant_bits,
                fuse_mlp=cfg.serve_fuse_mlp, compute_dtype=cfg.compute_dtype,
                occ_res=cfg.occ_res, device=device, **args[min(i, len(args) - 1)])
            for i in range(cfg.num_proposal_iterations))
        if cfg.distill_sam:
            self.sam_field = SAMField(
                grid_layers=cfg.hashgrid_layers, grid_sizes=cfg.hashgrid_sizes,
                grid_resolutions=cfg.hashgrid_resolutions,
                hidden_layers=cfg.hidden_layers, use_dino=cfg.use_dino_feature,
                use_clipseg=cfg.use_clipseg_feature, hash_q8=cfg.hash_q8_serve,
                hash_fn=cfg.hash_fn,
                quant_bits=cfg.serve_quant_bits_sam or cfg.serve_quant_bits,
                fuse_mlp=cfg.serve_fuse_mlp, compute_dtype=cfg.compute_dtype,
                device=device)
            self.conv = ConvHead(kernel_size=cfg.kernel_size,
                                 compute_dtype=cfg.compute_dtype, device=device)

    def forward(self, ray_bundle: RayBundle, get_features: Sequence[str] = (),
                bg_color: Optional[torch.Tensor] = None,
                return_topk: bool = False, train: bool = False,
                jitter: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                anneal: float = 1.0,
                proposal_grad: float = 1.0,
                occupancy: Optional[ServeOccupancy] = None) -> Dict[str, Any]:
        """Render a flat bundle of rays.

        ``get_features`` is a subset of ("sam", "dino", "clipseg"); with
        "sam" and ``patch_size > 1`` rays arrive patch-major.  ``return_topk`` also
        emits the per-ray top-k sharpened weights ``topk_w`` [R, K, 1] and
        euclidean sample mids ``topk_mid`` [R, K] for the fused feature
        pass of :mod:`samnerf_tpu_torch.engine.eval_render`.

        ``train`` builds the autograd graph and returns ``weights_list``
        and ``ray_samples_list`` (proposal levels, then the nerf level) for
        the losses; eval runs under ``torch.no_grad`` and returns
        ``prop_depth_i``.  Training samples are stratified by ``jitter``
        (uniform [0, 1) tensors, one per level: [R, 1] with
        ``use_single_jitter``, else [R, S+1]) or, without it, by draws from
        ``generator``; with neither they are not jittered, as the JAX
        model without an rng.  ``anneal`` and ``proposal_grad`` are the
        values of :func:`proposal_anneal_value` and
        :func:`proposal_grad_gate` for this step, floats or 0-d tensors
        (a CUDA graph's per-step values).

        ``occupancy`` (serve): a grid from
        :func:`samnerf_tpu_torch.ops.occupancy.pack_serve_occupancy` that
        every proposal network and the nerf field cull with, so sampling
        changes too."""
        if not train:
            with torch.no_grad():
                return self._forward(ray_bundle, get_features, bg_color,
                                     return_topk, False, None, 1.0, None, occupancy)
        if jitter is None and generator is not None:
            jitter = self.draw_jitter(ray_bundle.origins.shape[0], generator,
                                      ray_bundle.origins.device)
        return self._forward(ray_bundle, get_features, bg_color, return_topk,
                             True, jitter, anneal, proposal_grad, occupancy)

    def draw_jitter(self, num_rays: int, generator: torch.Generator,
                    device) -> Tuple[torch.Tensor, ...]:
        """One uniform [0, 1) tensor per sampling level."""
        cfg = self.config
        counts = list(cfg.num_proposal_samples_per_ray) + [cfg.num_nerf_samples_per_ray]
        return tuple(
            torch.rand((num_rays, 1 if cfg.use_single_jitter else s + 1),
                       generator=generator, device=device)
            for s in counts)

    def _forward(self, ray_bundle, get_features, bg_color, return_topk, train,
                 jitter, anneal, proposal_grad, occupancy) -> Dict[str, Any]:
        cfg = self.config
        if ray_bundle.nears is None or ray_bundle.fars is None:
            ray_bundle = ray_bundle.with_near_far(cfg.near_plane, cfg.far_plane)
        density_fns = [lambda pos, p=p: p(pos, occupancy) for p in self.proposal_networks]
        ray_samples, weights_list, ray_samples_list = proposal_sampling(
            ray_bundle, density_fns,
            cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray,
            jitter=jitter, anneal=anneal, proposal_grad=proposal_grad)
        live_et = None
        if not train and cfg.serve_transmittance_eps > 0.0:
            live_et = _early_termination(weights_list[-1], ray_samples_list[-1],
                                         ray_samples, cfg.serve_transmittance_eps)
        field_out = self.fields(ray_samples.positions(), ray_samples.directions,
                                occupancy, live_et, ray_bundle.camera_indices, train)
        weights = ray_samples.get_weights(field_out["density"])
        if bg_color is not None:
            rgb = render_ops.render_rgb(field_out["rgb"], weights,
                                        background_color="explicit", bg_rgb=bg_color,
                                        training=train)
        else:
            rgb = render_ops.render_rgb(field_out["rgb"], weights,
                                        background_color=cfg.background_color,
                                        training=train)
        outputs: Dict[str, Any] = {
            "rgb": rgb,
            "accumulation": render_ops.render_accumulation(weights),
            "depth": render_ops.render_depth_median(weights, ray_samples),
        }
        if train:
            outputs["weights_list"] = weights_list + [weights]
            outputs["ray_samples_list"] = ray_samples_list + [ray_samples]
        else:
            for i in range(cfg.num_proposal_iterations):
                outputs[f"prop_depth_{i}"] = render_ops.render_depth_median(
                    weights_list[i], ray_samples_list[i])

        if cfg.distill_sam and (len(get_features) > 0 or return_topk):
            # the feature render's weights carry no gradient
            sam_weights, best_ids = render_ops.topk_sharpened_weights(
                weights.detach(), cfg.num_sam_samples, cfg.sharpening_temperature)
            sam_samples = ray_samples.take_topk(best_ids)
            if return_topk:
                outputs["topk_w"] = sam_weights
                outputs["topk_mid"] = ((sam_samples.starts + sam_samples.ends)
                                       * 0.5)[..., 0]
            if len(get_features) > 0:
                outputs.update(self.features_from_topk(
                    sam_samples.positions(), sam_weights, tuple(get_features),
                    cull=not train))
        return outputs

    def features_from_topk(self, positions: torch.Tensor, weights: torch.Tensor,
                           get_features: Sequence[str],
                           cull: bool = False) -> Dict[str, Any]:
        """SAM / DINO / ClipSeg field at pre-selected top-k samples:
        positions [R, K, 3], sharpened weights [R, K, 1] -> weighted means, the SAM
        one through the patch conv head.  ``cull`` (serve only): zero-weight
        samples take the sentinel position (exact; see ``SAMField``).  The
        serve path calls this under ``torch.no_grad``."""
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
        if "dino" in feats:
            out["dino"] = render_ops.render_mean(feats["dino"], weights)
        if "clipseg" in feats:
            out["clipseg"] = render_ops.render_mean(feats["clipseg"], weights)
        return out


def _early_termination(prop_weights: torch.Tensor, prop_samples: RaySamples,
                       samples: RaySamples, eps: float) -> torch.Tensor:
    """[R, S, 1] 0/1: nerf samples whose transmittance estimate exceeds
    ``eps``.  The estimate before a sample is 1 minus the summed weights of
    the proposal bins [R, P] that end at or before its mid; the sum runs
    over P as the JAX package's does (a cumulative sum adds in another
    order and can flip a sample that sits at ``eps``).  Holds an [R, S, P]
    f32 intermediate."""
    pw = prop_weights[..., 0]
    pend = prop_samples.ends[..., 0]
    tmid = (samples.starts + samples.ends)[..., 0] * 0.5
    passed = pend[:, None, :] <= tmid[:, :, None]
    t_est = 1.0 - torch.sum(torch.where(passed, pw[:, None, :], 0.0), dim=-1)
    return (t_est > eps).to(torch.float32)[..., None]


def init_params(config: SAMModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded state for ``SAMModel(config)``: hash tables U(-1e-4, 1e-4)
    (the tcnn and JAX default), dense and conv weights lecun-normal,
    biases zero."""
    return init_state(SAMModel(config, device="meta"), generator, device)


def get_loss_dict(config: SAMModelConfig, outputs: Dict[str, Any],
                  batch: Dict[str, torch.Tensor],
                  feature_denoms: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Training losses.  ``batch['image']`` is [R, 3]; with patch_size > 1
    the SAM target ``batch['sam']`` is per patch [R / ps^2, 256]; the DINO
    and ClipSeg targets are per ray.  ``feature_denoms`` ("sam", "dino",
    "clipseg"): the denominators of the masked feature losses
    (``ops.losses.masked_feature_mse``), as data parallelism sets them."""
    denoms = feature_denoms or {}
    loss_dict = {"rgb_loss": torch.mean((batch["image"] - outputs["rgb"]) ** 2)}
    if "weights_list" in outputs:
        loss_dict["interlevel_loss"] = config.interlevel_loss_mult * loss_ops.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"])
        loss_dict["distortion_loss"] = config.distortion_loss_mult * loss_ops.distortion_loss(
            outputs["weights_list"], outputs["ray_samples_list"])
    if config.distill_sam and "sam" in outputs:
        loss_dict["sam_loss"] = config.sam_loss_weight * loss_ops.masked_feature_mse(
            outputs["sam"], batch["sam"], denoms.get("sam"))
        if config.use_dino_feature and "dino" in outputs:
            loss_dict["dino_loss"] = config.dino_loss_weight * loss_ops.masked_feature_mse(
                outputs["dino"], batch["dino"], denoms.get("dino"))
        if config.use_clipseg_feature and "clipseg" in outputs:
            loss_dict["clipseg_loss"] = config.clipseg_loss_weight * \
                loss_ops.masked_feature_mse(outputs["clipseg"], batch["clipseg"],
                                            denoms.get("clipseg"))
    return loss_dict


def proposal_anneal_value(config: SAMModelConfig, step: int) -> float:
    """Weight-anneal exponent (mipnerf360 eq. 18), in f32 as the JAX
    package computes it."""
    f32 = np.float32
    n = config.proposal_weights_anneal_max_num_iters
    b = f32(config.proposal_weights_anneal_slope)
    frac = np.clip(f32(step) / f32(n), f32(0.0), f32(1.0))
    return float((b * frac) / ((b - f32(1.0)) * frac + f32(1.0)))


def proposal_grad_gate(config: SAMModelConfig, step: int,
                       steps_since_update: int) -> float:
    """1.0 when the proposal networks get gradients this step, else 0.0:
    every step for the first 10, then once per ``sched`` steps, where
    ``sched`` ramps from 1 to ``proposal_update_every`` over the warmup."""
    f32 = np.float32
    sched = np.interp(f32(step), [0.0, float(config.proposal_warmup)],
                      [0.0, float(config.proposal_update_every)])
    sched = np.clip(f32(sched), 1.0, float(config.proposal_update_every))
    return 1.0 if (f32(steps_since_update) > sched or step < 10) else 0.0
