"""Learned per-camera pose refinement.

Counterpart of ``samnerf_tpu/core/camera_optimizers.py``: zero-initialised
6-dof tangents per camera, exponentiated to [R | t] deltas that
right-multiply the dataset's camera-to-worlds (``generate_rays``'
``camera_opt_to_camera``).  Off in the samnerf presets; neither package's
``Trainer`` attaches one.  The hash encodes give no gradient with respect
to positions, so pose gradients flow through the ray directions only.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from samnerf_tpu_torch.core.lie_groups import (exp_map_SE3, exp_map_SO3xR3,
                                               multiply_poses)

MODES = ("off", "SO3xR3", "SE3")


class CameraOptimizer(nn.Module):
    """``mode``: "off", "SO3xR3" or "SE3"; any other raises ValueError.
    Its parameter ``pose_adjustment`` [num_cameras, 6] starts at zero (and
    does not exist when off)."""

    def __init__(self, num_cameras: int, mode: str = "off", device="cuda"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown camera optimizer mode {mode!r}")
        self.num_cameras = num_cameras
        self.mode = mode
        if mode != "off":
            self.pose_adjustment = nn.Parameter(
                torch.zeros((num_cameras, 6), device=device))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [R] int -> camera_opt_to_camera deltas [R, 3, 4]."""
        if self.mode == "off":
            eye = torch.eye(4, device=indices.device)[:3, :4]
            return eye.expand(indices.shape[0], 3, 4)
        tangent = self.pose_adjustment[indices.long()]
        if self.mode == "SO3xR3":
            return exp_map_SO3xR3(tangent)
        return exp_map_SE3(tangent)


def apply_pose_adjustment(c2w: torch.Tensor,
                          camera_opt_to_camera: Optional[torch.Tensor]) -> torch.Tensor:
    """c2w [R, 3, 4] composed with per-ray deltas (None: unchanged)."""
    if camera_opt_to_camera is None:
        return c2w
    return multiply_poses(c2w, camera_opt_to_camera)
