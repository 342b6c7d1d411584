"""Registry of the non-flagship model families and their train step.

Counterpart of ``samnerf_tpu/configs/zoo.py``: each ``ZooMethod`` bundles
a model builder, its loss, its Adam lr and whether it trains with an
occupancy grid, with the JAX registry's names and values.  The JAX
package's ``dispatch_chunk`` and ``make_zoo_train_chunk`` only schedule
the TPU (one ``lax.scan`` of 16 or 2 steps per device dispatch, short for
the slow nerfplayer steps); the port runs steps one by one, as its
``Trainer`` does, so neither is here.  ``make_zoo_train_step`` is one
Adam step over every parameter (optax ``adam(lr)``: one group, b1 0.9, b2
0.999, eps 1e-8, a constant lr) through the port's ``GroupedAdam``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig, group_of
from samnerf_tpu_torch.utils.init import init_state

ADAM_EPS = 1e-8
"""optax ``adam``'s default eps, which the JAX zoo keeps."""


@dataclasses.dataclass
class ZooMethod:
    """A registered method; ``build(device)`` imports its model lazily and
    returns (model, config)."""
    name: str
    build: Callable[..., Tuple[nn.Module, Any]]
    loss_fn: Callable[..., Dict]
    loss_needs_config: bool = False
    loss_needs_params: bool = False
    """The loss reads the model's parameters (TensoRF's L1 term): it gets
    the model after the config."""
    use_occupancy: bool = False
    """Train with an occupancy grid and pass it to the model as
    ``occupancy`` (instant-ngp, nerfplayer-ngp)."""
    lr: float = 1e-2


def _vanilla(device="cuda"):
    from samnerf_tpu_torch.models import vanilla_nerf as m
    cfg = m.VanillaNerfConfig()
    return m.VanillaNerfModel(cfg, device=device), cfg


def _mipnerf(device="cuda"):
    from samnerf_tpu_torch.models import mipnerf as m
    cfg = m.MipNerfConfig()
    return m.MipNerfModel(cfg, device=device), cfg


def _instant_ngp(device="cuda"):
    from samnerf_tpu_torch.models import instant_ngp as m
    cfg = m.InstantNGPConfig()
    return m.InstantNGPModel(cfg, device=device), cfg


def _tensorf(device="cuda"):
    from samnerf_tpu_torch.models import tensorf as m
    cfg = m.TensoRFConfig()
    return m.TensoRFModel(cfg, device=device), cfg


def _depth_nerfacto(device="cuda"):
    from samnerf_tpu_torch.models import depth_nerfacto as m
    cfg = m.DepthNerfactoConfig()
    return m.DepthNerfactoModel(cfg.base, device=device), cfg


def _semantic_nerfw(device="cuda"):
    from samnerf_tpu_torch.models import semantic_nerfw as m
    cfg = m.SemanticNerfWConfig()
    return m.SemanticNerfWModel(cfg, device=device), cfg


def _nerfplayer(device="cuda"):
    from samnerf_tpu_torch.models import nerfplayer as m
    cfg = m.NerfPlayerConfig()
    return m.NerfPlayerModel(cfg, device=device), cfg


def zoo_methods() -> Dict[str, ZooMethod]:
    from samnerf_tpu_torch.models import (depth_nerfacto, instant_ngp, mipnerf,
                                          nerfplayer, semantic_nerfw, tensorf,
                                          vanilla_nerf)
    return {
        "vanilla-nerf": ZooMethod("vanilla-nerf", _vanilla, vanilla_nerf.get_loss_dict,
                                  lr=5e-4),
        "mipnerf": ZooMethod("mipnerf", _mipnerf, mipnerf.get_loss_dict, lr=5e-4),
        "instant-ngp": ZooMethod("instant-ngp", _instant_ngp, instant_ngp.get_loss_dict,
                                 use_occupancy=True),
        "tensorf": ZooMethod("tensorf", _tensorf, tensorf.get_loss_dict,
                             loss_needs_config=True, loss_needs_params=True),
        "depth-nerfacto": ZooMethod("depth-nerfacto", _depth_nerfacto,
                                    depth_nerfacto.get_loss_dict, loss_needs_config=True),
        "semantic-nerfw": ZooMethod("semantic-nerfw", _semantic_nerfw,
                                    semantic_nerfw.get_loss_dict, loss_needs_config=True),
        "nerfplayer-nerfacto": ZooMethod("nerfplayer-nerfacto", _nerfplayer,
                                         nerfplayer.get_loss_dict),
        "nerfplayer-ngp": ZooMethod("nerfplayer-ngp", _nerfplayer, nerfplayer.get_loss_dict,
                                    use_occupancy=True),
    }


def init_zoo_params(model: nn.Module, generator: torch.Generator,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """A seeded state: the model's own ``init_params`` where it has one
    (TensoRF's factors), else :func:`init_state` (hash tables
    U(-1e-4, 1e-4), lecun-normal weights, zero biases)."""
    if hasattr(model, "init_params"):
        return model.init_params(generator, device)
    return init_state(model, generator, device)


def zoo_optimizer(model: nn.Module, lr: float) -> GroupedAdam:
    """One Adam at a constant ``lr`` over every parameter (a group per
    top-level module, all with the same settings)."""
    cfg = OptimizerGroupConfig(lr=lr, eps=ADAM_EPS)
    return GroupedAdam({group_of(n): cfg for n, _ in model.named_parameters()}, model)


def zoo_losses(method: ZooMethod, model: nn.Module, config, outputs,
               batch) -> Dict[str, torch.Tensor]:
    if method.loss_needs_config and method.loss_needs_params:
        return method.loss_fn(config, model, outputs, batch)
    if method.loss_needs_config:
        return method.loss_fn(config, outputs, batch)
    return method.loss_fn(outputs, batch)


def zoo_loss_and_grads(method: ZooMethod, model: nn.Module, config, cameras: Cameras,
                       batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       occupancy: Optional[torch.Tensor] = None,
                       draws: Optional[Dict[str, Any]] = None):
    """Forward and backward of one step on the rays of ``batch["indices"]``
    (image, row, col): leaves the gradients in ``.grad`` (every zoo model's
    graph reaches all its parameters) and returns (loss dict, total).
    ``draws`` are the model's random inputs, else drawn from
    ``generator``.  The total sums the losses in key order, as
    ``jax.tree.leaves`` does."""
    idx = batch["indices"]
    bundle = generate_rays(cameras, idx[:, 0], idx[:, 1:])
    kw = dict(draws or {})
    if method.use_occupancy:
        kw["occupancy"] = occupancy
    outputs = model(bundle, train=True, generator=generator, **kw)
    losses = zoo_losses(method, model, config, outputs, batch)
    total = sum(losses[k] for k in sorted(losses))
    total.backward()
    return losses, total


def make_zoo_train_step(method: ZooMethod, model: nn.Module, config,
                        optimizer: GroupedAdam) -> Callable:
    """(cameras, batch, generator, occupancy, draws) -> metrics (the losses
    and ``total_loss``, on the device); updates the parameters in place."""

    def step(cameras: Cameras, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             occupancy: Optional[torch.Tensor] = None,
             draws: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        losses, total = zoo_loss_and_grads(method, model, config, cameras, batch,
                                           generator, occupancy, draws)
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step
