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
    - weights of rank >= 2 (linear, conv, embedding, an attention's
      ``in_proj_weight``): normal with variance 1 / fan_in, fan_in = the
      product of all but the leading dim (lecun normal, untruncated);
    - norm weights of rank 1: ones; biases (and ``in_proj_bias``): zeros;
    - the ViTs' position embeddings, rel-pos tables and DINO's class token
      (``pos_embed``, ``rel_pos_h``, ``rel_pos_w``, ``cls_token``; zeros or
      truncated normal in the references' inits): normal with std 0.02, so
      the bias they give is not zero;
    - CLIP's ``class_embedding``, ``positional_embedding``, ``proj`` and
      ``text_projection``: normal with std width ** -0.5, CLIP's own scale
      (width the last dim of a position embedding, else the leading one);
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
        elif leaf in ("bias", "in_proj_bias"):
            t = torch.zeros(shape)
        elif leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            t = torch.randn(shape, generator=generator, device=gdev) \
                / math.sqrt(fan_in)
        elif leaf == "weight":
            t = torch.ones(shape)
        elif leaf in ("pos_embed", "rel_pos_h", "rel_pos_w", "cls_token"):
            t = torch.randn(shape, generator=generator, device=gdev) * 0.02
        elif leaf in ("class_embedding", "positional_embedding", "proj", "text_projection"):
            width = shape[-1] if leaf == "positional_embedding" else shape[0]
            t = torch.randn(shape, generator=generator, device=gdev) * width ** -0.5
        else:
            t = torch.randn(shape, generator=generator, device=gdev)
        state[name] = t.to(device)
    return state
