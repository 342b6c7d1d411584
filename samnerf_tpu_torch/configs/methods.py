"""Method presets ``samnerf_no_distill`` and ``samnerf_distill``.

Counterpart of ``samnerf_tpu/configs/methods.py``, same hyperparameters,
the trainer's ``steps_per_dispatch`` (20 steps a dispatch: a CUDA graph
replay on the card) included.  Left out: ``sort_points`` and
``use_remat`` (they only schedule the TPU; the sort is exact and
order-restoring, and activations fit the card).  ``vis`` selects the event writers and the viewer as in the
JAX package; the viewer listens on ``websocket_port`` and serves its
client on ``http_port``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

from samnerf_tpu_torch.data.datamanager import DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.engine.optimizers import OptimizerGroupConfig
from samnerf_tpu_torch.engine.trainer import TrainerConfig
from samnerf_tpu_torch.models.sam_model import SAMModelConfig


@dataclasses.dataclass
class MethodConfig:
    method_name: str
    trainer: TrainerConfig
    model: SAMModelConfig
    datamanager: DataManagerConfig
    optimizers: Dict[str, OptimizerGroupConfig]
    vis: str = "viewer"
    """Any of "viewer", "tensorboard", "wandb", "json", combinable
    ("tensorboard+json")."""
    websocket_port: int = 7007
    http_port: int = 7008


def _no_distill(data: Path = Path("/data/mipnerf360/room/")) -> MethodConfig:
    max_steps = 30000
    return MethodConfig(
        method_name="samnerf_no_distill",
        trainer=TrainerConfig(max_num_iterations=max_steps, steps_per_save=2000,
                              steps_per_eval_batch=50000,
                              steps_per_eval_image=10000000),
        model=SAMModelConfig(
            distill_sam=False, use_clipseg_feature=False, kernel_size=3,
            hidden_layers=1, patch_size=1, sam_loss_weight=1.0,
            num_proposal_samples_per_ray=(64,), num_nerf_samples_per_ray=32,
            num_sam_samples=3, hash_fn="morton"),
        datamanager=DataManagerConfig(
            dataparser=DataparserConfig(data=data, scale_factor=1.0,
                                        train_val_json_split=True),
            train_num_rays_per_batch=4096 * 4, eval_num_rays_per_batch=4096 * 4,
            patch_size=1, distill_sam=False),
        optimizers={
            "proposal_networks": OptimizerGroupConfig(
                lr=1e-2, eps=1e-15, lr_final=5e-4, max_steps=max_steps),
            "fields": OptimizerGroupConfig(
                lr=1e-2, eps=1e-15, lr_final=5e-4, max_steps=max_steps),
        })


def _distill(data: Path = Path("/data/mipnerf360/room/")) -> MethodConfig:
    max_steps = 10000
    return MethodConfig(
        method_name="samnerf_distill",
        trainer=TrainerConfig(max_num_iterations=max_steps, steps_per_save=2000,
                              steps_per_eval_batch=5000000,
                              steps_per_eval_image=10000000),
        model=SAMModelConfig(
            distill_sam=True, use_clipseg_feature=True, kernel_size=3,
            hidden_layers=1, patch_size=4, sam_loss_weight=1.0,
            num_proposal_samples_per_ray=(64,), num_nerf_samples_per_ray=32,
            num_sam_samples=16, hash_fn="morton"),
        datamanager=DataManagerConfig(
            dataparser=DataparserConfig(data=data, scale_factor=1.0,
                                        train_val_json_split=True),
            train_num_rays_per_batch=4096 * 4, eval_num_rays_per_batch=4096 * 4,
            patch_size=4, distill_sam=True, use_clipseg_feature=True),
        optimizers={
            "proposal_networks": OptimizerGroupConfig(
                lr=1e-2, eps=1e-15, lr_final=5e-4, max_steps=max_steps),
            "fields": OptimizerGroupConfig(
                lr=1e-2, eps=1e-15, lr_final=5e-4, max_steps=max_steps),
            "conv": OptimizerGroupConfig(
                lr=5e-4, eps=1e-15, lr_final=1e-4, max_steps=max_steps),
            "sam_field": OptimizerGroupConfig(
                lr=5e-4, eps=1e-15, lr_final=1e-4, max_steps=max_steps),
        })


def method_configs() -> Dict[str, MethodConfig]:
    return {"samnerf_no_distill": _no_distill(), "samnerf_distill": _distill()}
