"""Cameras and ray generation.

Counterpart of ``samnerf_tpu/core/cameras.py`` (``Cameras``,
``undistort_coords`` :63, ``generate_rays`` :87, with the viewer's crop
box).  Conventions: coords are (row, col) with pixel centers at +0.5;
camera-plane coords [(x-cx)/fx, -(y-cy)/fy], undistorted when the cameras
carry ``distortion_params`` (OpenCV k1 k2 k3 k4 p1 p2, JAX's fixed
three-step solve); the camera-space direction is [x, y, -1] for
perspective cameras (OpenGL), the equidistant model for fisheye and the
longitude / latitude map for equirectangular ones (``camera_type``: all
three computed and selected per ray, as the JAX package does); then
rotated by c2w and normalized; pixel_area from the +1-pixel neighbours of
the normalized world directions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from samnerf_tpu_torch.core.rays import RayBundle

PERSPECTIVE = 1
FISHEYE = 2
EQUIRECTANGULAR = 3


@dataclasses.dataclass(frozen=True)
class Cameras:
    camera_to_worlds: torch.Tensor  # [N, 3, 4]
    fx: torch.Tensor  # [N, 1]
    fy: torch.Tensor  # [N, 1]
    cx: torch.Tensor  # [N, 1]
    cy: torch.Tensor  # [N, 1]
    width: int
    height: int
    distortion_params: Optional[torch.Tensor] = None  # [N, 6] k1 k2 k3 k4 p1 p2
    camera_type: Optional[torch.Tensor] = None  # [N, 1] int, default PERSPECTIVE

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    def to(self, device) -> "Cameras":
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, camera_to_worlds=self.camera_to_worlds.to(device),
            fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
            distortion_params=move(self.distortion_params),
            camera_type=move(self.camera_type))

    def rescale_output_resolution(self, scaling_factor: float) -> "Cameras":
        """Intrinsics and image size scaled by ``scaling_factor``."""
        return dataclasses.replace(
            self, fx=self.fx * scaling_factor, fy=self.fy * scaling_factor,
            cx=self.cx * scaling_factor, cy=self.cy * scaling_factor,
            width=int(round(self.width * scaling_factor)),
            height=int(round(self.height * scaling_factor)))


def undistort_coords(coords: torch.Tensor, distortion: torch.Tensor,
                     num_iters: int = 3) -> torch.Tensor:
    """Ideal camera-plane coords [..., 2] from distorted ones under the
    OpenCV model (``distortion`` [..., 6]: k1 k2 k3 k4 p1 p2), by the JAX
    package's fixed ``num_iters`` steps: each subtracts the residual
    divided by the radial factor (floored at 1e-6), a diagonal stand-in
    for the Jacobian, not a full Newton solve."""
    k1, k2, k3, k4 = (distortion[..., i] for i in range(4))
    p1, p2 = distortion[..., 4], distortion[..., 5]
    x, y = coords[..., 0], coords[..., 1]
    xd, yd = x, y
    for _ in range(num_iters):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fx_ = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - xd
        fy_ = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y) - yd
        x = x - fx_ / torch.clamp_min(d, 1e-6)
        y = y - fy_ / torch.clamp_min(d, 1e-6)
    return torch.stack([x, y], dim=-1)


def intersect_aabb(origins: torch.Tensor, directions: torch.Tensor,
                   aabb: torch.Tensor, max_bound: float = 1e10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/box intersection (``samnerf_tpu/utils/misc.py:22``):
    origins, directions [..., 3], aabb [6] (min xyz, max xyz) -> t_min,
    t_max [..., 1], each clamped to [0, max_bound]; a miss gives t_min >
    t_max."""
    inv = 1.0 / torch.where(directions.abs() < 1e-10, 1e-10, directions)
    t0 = (aabb[:3] - origins) * inv
    t1 = (aabb[3:] - origins) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    return tmin.clamp(0.0, max_bound), tmax.clamp(0.0, max_bound)


def generate_rays(cameras: Cameras, camera_indices: torch.Tensor,
                  coords: torch.Tensor, pixel_offset: float = 0.5,
                  aabb_box: Optional[torch.Tensor] = None) -> RayBundle:
    """camera_indices [R] int, coords [R, 2] (row, col) -> RayBundle [R].
    ``aabb_box`` [2, 3] (min corner, max corner): the viewer's crop box;
    near and far then bound each ray to it, as the reference's crop does
    (``samnerf_tpu/core/cameras.py:161-166``)."""
    ci = camera_indices.long()
    y = coords[..., 0].float() + pixel_offset
    x = coords[..., 1].float() + pixel_offset
    fx, fy = cameras.fx[ci, 0], cameras.fy[ci, 0]
    cx, cy = cameras.cx[ci, 0], cameras.cy[ci, 0]
    cxs = torch.stack([(x - cx) / fx, (x - cx + 1.0) / fx, (x - cx) / fx])
    cys = torch.stack([-(y - cy) / fy, -(y - cy) / fy, -(y - cy + 1.0) / fy])
    coord_stack = torch.stack([cxs, cys], dim=-1)  # [3, R, 2]
    if cameras.distortion_params is not None:
        coord_stack = undistort_coords(coord_stack, cameras.distortion_params[ci][None])
    dirs_cam = torch.cat([coord_stack, -torch.ones_like(coord_stack[..., :1])], dim=-1)
    if cameras.camera_type is not None:
        ctype = cameras.camera_type[ci, 0][None, :, None]  # [1, R, 1]
        theta_f = torch.clamp(torch.sqrt(torch.sum(coord_stack ** 2, dim=-1)), 1e-6, math.pi)
        sin_t = torch.sin(theta_f) / theta_f
        dirs_fish = torch.stack([coord_stack[..., 0] * sin_t, coord_stack[..., 1] * sin_t,
                                 -torch.cos(theta_f)], dim=-1)
        theta_e = -math.pi * coord_stack[..., 0]
        phi = math.pi * (0.5 - coord_stack[..., 1])
        dirs_eq = torch.stack([-torch.sin(theta_e) * torch.sin(phi), torch.cos(phi),
                               -torch.cos(theta_e) * torch.sin(phi)], dim=-1)
        dirs_cam = torch.where(ctype == FISHEYE, dirs_fish,
                               torch.where(ctype == EQUIRECTANGULAR, dirs_eq, dirs_cam))
    c2w = cameras.camera_to_worlds[ci]  # [R, 3, 4]
    rotation = c2w[..., :3, :3]
    dirs_world = torch.sum(dirs_cam[..., None, :] * rotation[None], dim=-1)
    norms = torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    dirs_world = dirs_world / torch.clamp_min(norms, 1e-12)
    directions = dirs_world[0]
    dx = torch.sqrt(torch.sum((directions - dirs_world[1]) ** 2, dim=-1))
    dy = torch.sqrt(torch.sum((directions - dirs_world[2]) ** 2, dim=-1))
    nears = fars = None
    if aabb_box is not None:
        nears, t_max = intersect_aabb(c2w[..., :3, 3], directions,
                                      aabb_box.reshape(6))
        fars = torch.maximum(t_max, nears)
    return RayBundle(origins=c2w[..., :3, 3], directions=directions,
                     pixel_area=(dx * dy)[..., None],
                     camera_indices=ci[..., None], nears=nears, fars=fars)
