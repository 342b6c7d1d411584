"""Seeded parameter states for the port's modules."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def init_state(module: nn.Module, generator: torch.Generator, device="cuda",
               table_scale: float = 1e-4) -> Dict[str, torch.Tensor]:
    """A state dict for ``module`` (which may live on the meta device),
    drawn from ``generator`` on its own device and moved to ``device``
    (one seed gives one state on any device):

    - hash tables (``*.table``): U(-table_scale, table_scale);
    - weights of rank >= 2 (linear, conv, embedding): normal with variance
      1 / fan_in, fan_in = the product of all but the leading dim
      (lecun normal, untruncated);
    - norm weights of rank 1: ones; biases: zeros;
    - any other tensor (a positional-encoding matrix): standard normal.
    """
    gdev = generator.device
    state = {}
    for name, ref in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(ref.shape)
        if leaf == "table":
            t = (torch.rand(shape, generator=generator, device=gdev) * 2.0
                 - 1.0) * table_scale
        elif leaf == "bias":
            t = torch.zeros(shape)
        elif leaf == "weight" and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            t = torch.randn(shape, generator=generator, device=gdev) \
                / math.sqrt(fan_in)
        elif leaf == "weight":
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=generator, device=gdev)
        state[name] = t.to(device)
    return state
