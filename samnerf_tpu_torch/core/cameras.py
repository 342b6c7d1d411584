"""Pinhole cameras and ray generation.

Counterpart of ``samnerf_tpu/core/cameras.py`` (``Cameras``,
``generate_rays`` :87) for perspective cameras without distortion, the
only kind the serve path renders; fisheye, equirectangular, distortion
and crop boxes wait.  Conventions: coords are (row, col) with pixel
centers at +0.5; camera-space direction [(x-cx)/fx, -(y-cy)/fy, -1]
(OpenGL), rotated by c2w and normalized; pixel_area from the +1-pixel
neighbours of the normalized world directions.
"""
from __future__ import annotations

import dataclasses

import torch

from samnerf_tpu_torch.core.rays import RayBundle


@dataclasses.dataclass(frozen=True)
class Cameras:
    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: int
    height: int

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self, camera_to_worlds=self.camera_to_worlds.to(device),
            fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device))


def generate_rays(cameras: Cameras, camera_indices: torch.Tensor,
                  coords: torch.Tensor, pixel_offset: float = 0.5) -> RayBundle:
    """camera_indices [R] int, coords [R, 2] (row, col) -> RayBundle [R]."""
    ci = camera_indices.long()
    y = coords[..., 0].float() + pixel_offset
    x = coords[..., 1].float() + pixel_offset
    fx, fy = cameras.fx[ci, 0], cameras.fy[ci, 0]
    cx, cy = cameras.cx[ci, 0], cameras.cy[ci, 0]
    cxs = torch.stack([(x - cx) / fx, (x - cx + 1.0) / fx, (x - cx) / fx])
    cys = torch.stack([-(y - cy) / fy, -(y - cy) / fy, -(y - cy + 1.0) / fy])
    dirs_cam = torch.stack([cxs, cys, -torch.ones_like(cxs)], dim=-1)  # [3, R, 3]
    c2w = cameras.camera_to_worlds[ci]  # [R, 3, 4]
    rotation = c2w[..., :3, :3]
    dirs_world = torch.sum(dirs_cam[..., None, :] * rotation[None], dim=-1)
    norms = torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    dirs_world = dirs_world / torch.clamp_min(norms, 1e-12)
    directions = dirs_world[0]
    dx = torch.sqrt(torch.sum((directions - dirs_world[1]) ** 2, dim=-1))
    dy = torch.sqrt(torch.sum((directions - dirs_world[2]) ** 2, dim=-1))
    return RayBundle(origins=c2w[..., :3, 3], directions=directions,
                     pixel_area=(dx * dy)[..., None],
                     camera_indices=ci[..., None])
