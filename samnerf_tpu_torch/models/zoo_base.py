"""The calling convention the model zoo's models share.

A zoo model renders a flat ``RayBundle`` with ``model(ray_bundle,
train=..., generator=..., **draws)``.  Eval runs under ``torch.no_grad``
and draws nothing.  Training takes its random inputs as ``draws`` (the
sampler jitter, one uniform [0, 1) tensor per sampling level, and what
else the model names in :meth:`ZooModel.draw`), or without a ``jitter``
draws all of them from ``generator``; with neither it samples without
jitter, as the JAX models do without an rng.  The JAX models draw from
one key per step; a test hands the port those numbers as ``draws``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from samnerf_tpu_torch.ops.samplers import jitter_shape


class ZooModel(nn.Module):
    """Subclasses set ``jitter_levels`` (the sample counts of the levels
    whose jitter they draw, in order) and implement :meth:`render`."""

    jitter_levels: tuple = ()
    shared_jitter = False
    """One draw for every level: the JAX model passes the same key to
    each of its samplers, so all levels get the same numbers."""

    def draw(self, num_rays: int, generator: torch.Generator, device) -> Dict[str, Any]:
        """The random inputs of one training render: ``jitter``, [R, 1]
        per level."""
        if self.shared_jitter:
            u = torch.rand(jitter_shape(num_rays, self.jitter_levels[0]),
                           generator=generator, device=device)
            return {"jitter": tuple(u for _ in self.jitter_levels)}
        return {"jitter": tuple(
            torch.rand(jitter_shape(num_rays, s), generator=generator, device=device)
            for s in self.jitter_levels)}

    def forward(self, ray_bundle, train: bool = False,
                generator: Optional[torch.Generator] = None, **kwargs) -> Dict[str, Any]:
        if not train:
            with torch.no_grad():
                return self.render(ray_bundle, False, **kwargs)
        if generator is not None and kwargs.get("jitter") is None:
            kwargs = {**kwargs, **self.draw(ray_bundle.origins.shape[0], generator,
                                            ray_bundle.origins.device)}
        return self.render(ray_bundle, True, **kwargs)

    def render(self, ray_bundle, train: bool, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError
