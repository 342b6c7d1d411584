"""Per-group Adam with exponential-decay schedules.

Counterpart of ``samnerf_tpu/engine/optimizers.py``: one
``torch.optim.Adam`` whose parameter groups are the top-level state-dict
prefixes (``fields``, ``proposal_networks``, ``sam_field``, ``conv``),
each with its own schedule and optional clip, matching
``optax.multi_transform`` of ``clip_by_global_norm`` + ``adam``.

- optax's schedule reads the update count before incrementing it, so
  update ``k`` (0-based) uses ``lr(k)``; :meth:`GroupedAdam.step` sets each
  group's lr from the schedule before stepping.
- optax updates a leaf with a zero gradient (its moments decay, the leaf
  moves); ``torch.optim.Adam`` skips a parameter whose ``.grad`` is None.
  :meth:`GroupedAdam.step` therefore refuses a None gradient: the train
  step's graph reaches every parameter, with zeros where the proposal
  gate is shut.
- The state dict keys each parameter's moments by its state-dict name
  (``{"optimizer": {"state": {name: {"step", "exp_avg", "exp_avg_sq"}}},
  "count": n}``), not by torch's position index, so a state made
  elsewhere (:func:`samnerf_tpu_torch.convert.train_checkpoint_from_jax`)
  loads without knowing the parameter order; the groups' hyperparameters
  come from their configs.
- :meth:`GroupedAdam.device_step` is the same update in a form a CUDA
  graph can hold (the trainer's ``steps_per_dispatch`` blocks): eager
  Adam takes the step size ``s = -lr / (1 - beta1^t)`` and ``b = sqrt(1 -
  beta2^t)`` as float64 host scalars, which a graph would freeze; here
  the host computes the same float64 values for every step of a block
  (:meth:`GroupedAdam.block_scalars`), folded into ``b s`` and ``eps /
  s``, and the update reads those, rounded to f32, from a device buffer
  that is refilled before each replay: ``p += m / (sqrt(v) / (b s) + eps
  / s)``, as ``torch.optim.Adam(capturable=True)`` orders it (an
  ``addcdiv`` takes no device scalar), in as many passes over the
  parameters as the eager update.  The moments are the eager update's
  bit for bit; the parameter step rounds in another order, a few f32 ulps
  of ``|p| + lr`` apart per step.  The step counts stay on the CPU,
  advanced by the host (:meth:`GroupedAdam.advance`), so the state dict
  is the same in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: Optional[float] = None
    max_steps: int = 10000
    warmup_steps: int = 0
    lr_pre_warmup: float = 1e-8
    ramp: str = "cosine"
    max_norm: Optional[float] = None


def exponential_decay_schedule(cfg: OptimizerGroupConfig) -> Callable[[int], float]:
    """lr(step): optional warmup from ``lr_pre_warmup`` (cosine or linear
    ramp), then log-linear decay from ``lr`` to ``lr_final`` at
    ``max_steps``.  Computed in float64 on the host; the JAX package
    computes it in f32 on the device (relative difference ~1e-7)."""
    lr_init = cfg.lr
    lr_final = cfg.lr_final if cfg.lr_final is not None else cfg.lr

    def schedule(step: int) -> float:
        if step < cfg.warmup_steps:
            frac = step / cfg.warmup_steps
            if cfg.ramp == "cosine":
                return cfg.lr_pre_warmup + (1 - cfg.lr_pre_warmup) * math.sin(
                    0.5 * math.pi * min(max(frac, 0.0), 1.0))
            return cfg.lr_pre_warmup + (lr_init - cfg.lr_pre_warmup) * frac
        t = min(max((step - cfg.warmup_steps)
                    / max(cfg.max_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return schedule


def group_of(name: str) -> str:
    """Optimizer group of a state-dict name: its top-level prefix, with
    ``proposal_networks.i`` -> ``proposal_networks``."""
    return name.split(".", 1)[0]


class GroupedAdam:
    """Adam over named parameter groups with per-group schedules and
    global-norm clipping."""

    BETAS = (0.9, 0.999)

    def __init__(self, groups: Dict[str, OptimizerGroupConfig], model: nn.Module):
        params: Dict[str, list] = {}
        names: Dict[str, list] = {}
        for name, p in model.named_parameters():
            params.setdefault(group_of(name), []).append(p)
            names.setdefault(group_of(name), []).append(name)
        missing = set(params) - set(groups)
        if missing:
            raise ValueError(f"no optimizer group configured for params: {missing}")
        self.names = [g for g in groups if g in params]
        self.configs = {g: groups[g] for g in self.names}
        self.schedules = {g: exponential_decay_schedule(groups[g]) for g in self.names}
        self.optimizer = torch.optim.Adam(
            [{"params": params[g], "name": g, "lr": self.schedules[g](0),
              "eps": groups[g].eps} for g in self.names],
            betas=self.BETAS)
        # torch's state index of each parameter: groups in order, then params
        self.param_names = [n for g in self.names for n in names[g]]
        self.count = 0

    def _clipped_grads(self, group: dict):
        cfg = self.configs[group["name"]]
        grads = [p.grad for p in group["params"]]
        if any(g is None for g in grads):
            raise RuntimeError(f"a parameter of group {group['name']!r} has no "
                               "gradient; optax would update it with zeros")
        if cfg.max_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < cfg.max_norm, 1.0, cfg.max_norm / norm)
            for g in grads:
                g.mul_(scale)
        return grads

    def step(self) -> None:
        """One update of every group at ``lr(count)``."""
        for group in self.optimizer.param_groups:
            self._clipped_grads(group)
            group["lr"] = self.schedules[group["name"]](self.count)
        self.optimizer.step()
        self.count += 1

    def block_scalars(self, n: int) -> np.ndarray:
        """[n, groups, 2] f32: for each of the next ``n`` updates and each
        group, ``b s`` and ``eps / s`` of the step size ``s = -lr(count) /
        (1 - beta1^t)`` and ``b = sqrt(1 - beta2^t)`` (t = count + 1),
        computed in float64 as ``torch.optim.Adam`` computes ``s`` and
        ``b``, rounded once to f32."""
        beta1, beta2 = self.BETAS
        out = np.empty((n, len(self.names), 2), np.float32)
        for i in range(n):
            t = self.count + i + 1
            for j, g in enumerate(self.names):
                s = (self.schedules[g](self.count + i) / (1 - beta1 ** t)) * -1
                b = (1 - beta2 ** t) ** 0.5
                out[i, j] = b * s, self.configs[g].eps / s
        return out

    @torch.no_grad()
    def device_step(self, scalars: torch.Tensor) -> None:
        """One update of every group from ``scalars`` [groups, 2] (a row of
        :meth:`block_scalars` on the parameters' device), reading nothing
        back to the host and changing no host state: the caller advances
        the counts (:meth:`advance`) once the update has run, since a graph
        replays it where Python does not run.  The first call makes the
        moments, so it must not be captured."""
        for j, group in enumerate(self.optimizer.param_groups):
            grads = self._clipped_grads(group)
            params = group["params"]
            for p in params:
                state = self.optimizer.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            exp_avgs = [self.optimizer.state[p]["exp_avg"] for p in params]
            exp_avg_sqs = [self.optimizer.state[p]["exp_avg_sq"] for p in params]
            beta1, beta2 = self.BETAS
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, scalars[j, 0])
            # the list add of a 0-d device tensor reads it back to the host;
            # a tensor's own add does not
            for d in denom:
                d.add_(scalars[j, 1])
            torch._foreach_addcdiv_(params, exp_avgs, denom)

    def held(self) -> tuple:
        """The addresses of the parameters and moments :meth:`device_step`
        writes: a graph of it is captured anew when they change (a loaded
        state has new moments)."""
        state = self.optimizer.state
        return tuple(t.data_ptr() for g in self.optimizer.param_groups for p in g["params"]
                     for t in (p, *(v for k, v in state.get(p, {}).items() if k != "step")))

    def advance(self, n: int) -> None:
        """Count ``n`` updates made by :meth:`device_step`."""
        for state in self.optimizer.state.values():
            state["step"] += n
        self.count += n

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        state = self.optimizer.state_dict()["state"]
        return {"optimizer": {"state": {self.param_names[i]: s for i, s in state.items()}},
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        index = {name: i for i, name in enumerate(self.param_names)}
        moments = state["optimizer"]["state"]
        unknown = set(moments) - set(index)
        if unknown:
            raise KeyError(f"optimizer state for unknown parameters: {sorted(unknown)}")
        current = self.optimizer.state_dict()
        # moments go to each parameter's device; steps stay on the CPU, as
        # torch keeps them when Adam is not capturable
        current["state"] = {index[name]: {k: (v.cpu() if k == "step" else v)
                                          for k, v in s.items()}
                            for name, s in moments.items()}
        self.optimizer.load_state_dict(current)
        self.count = state["count"]


def build_optimizer(groups: Dict[str, OptimizerGroupConfig],
                    model: nn.Module) -> GroupedAdam:
    """Per-group Adam(eps per group, default 1e-15) + exp decay."""
    return GroupedAdam(groups, model)
