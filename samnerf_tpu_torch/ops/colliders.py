"""Scene colliders: per-ray near and far before sampling.

Counterpart of ``samnerf_tpu/ops/colliders.py`` (``near_far_collider``,
``aabb_collider``, ``sphere_collider``).
"""
from __future__ import annotations

import dataclasses

import torch

from samnerf_tpu_torch.core.rays import RayBundle


def near_far_collider(ray_bundle: RayBundle, near: float, far: float) -> RayBundle:
    """Constant near/far for every ray."""
    return ray_bundle.with_near_far(near, far)


def aabb_collider(ray_bundle: RayBundle, aabb: torch.Tensor,
                  near_plane: float = 0.0) -> RayBundle:
    """Ray/box slab intersection; ``aabb`` [2, 3] (min corner, max corner).
    Rays that miss the box get a zero-length segment (far = near + 1e-6),
    so their weights are zero."""
    d = ray_bundle.directions
    o = ray_bundle.origins
    inv = 1.0 / torch.where(torch.abs(d) < 1e-10, 1e-10, d)
    t0 = (aabb[0][None] - o) * inv
    t1 = (aabb[1][None] - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    nears = torch.clamp_min(tmin, near_plane)
    fars = torch.maximum(tmax, nears + 1e-6)
    return dataclasses.replace(ray_bundle, nears=nears, fars=fars)


def sphere_collider(ray_bundle: RayBundle, center: torch.Tensor, radius: float,
                    near_plane: float = 0.0) -> RayBundle:
    """Ray/sphere intersection; rays that miss get the segment at the
    closest approach, of length 1e-6."""
    o = ray_bundle.origins - center[None]
    d = ray_bundle.directions
    a = torch.sum(d * d, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(o * d, dim=-1, keepdim=True)
    c = torch.sum(o * o, dim=-1, keepdim=True) - radius ** 2
    sq = torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))
    nears = torch.clamp_min((-b - sq) / (2 * a), near_plane)
    fars = torch.maximum((-b + sq) / (2 * a), nears + 1e-6)
    return dataclasses.replace(ray_bundle, nears=nears, fars=fars)
