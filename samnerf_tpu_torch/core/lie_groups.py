"""Exponential maps for pose refinement.

Counterpart of ``samnerf_tpu/core/lie_groups.py``, same tangent layout
([tx ty tz, wx wy wz] -> [R | t]) and the same small-angle series, all
branch-free.  One difference: JAX's ``exp_map_SE3`` takes the square root
of |w|^2 before it selects the series branch, so its gradient at a zero
rotation is 0 * inf = NaN; here the root is taken of a value that is 1 on
that branch, which keeps every forward value and gives the series
branch's finite gradient there.
"""
from __future__ import annotations

import torch


def _skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """Exponential map of SO(3) x R^3: tangent [..., 6] (translation
    first) -> [..., 3, 4]."""
    t = tangent[..., :3]
    log_rot = tangent[..., 3:]
    nrms = torch.sum(log_rot * log_rot, dim=-1)
    angle = torch.sqrt(torch.clamp_min(nrms, 1e-4))
    fac1 = torch.sin(angle) / angle
    fac2 = (1.0 - torch.cos(angle)) / (angle * angle)
    skews = _skew(log_rot)
    rot = (fac1[..., None, None] * skews + fac2[..., None, None] * (skews @ skews)
           + torch.eye(3, dtype=tangent.dtype, device=tangent.device))
    return torch.cat([rot, t[..., None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3): tangent [..., 6] (translation first)
    -> [..., 3, 4]; |w| < 1e-2 takes the series branch."""
    lin = tangent[..., :3]
    ang = tangent[..., 3:]
    theta2 = torch.sum(ang * ang, dim=-1)
    near_zero = torch.sqrt(theta2.detach()) < 1e-2
    one = torch.ones_like(theta2)
    theta_nz = torch.sqrt(torch.where(near_zero, one, theta2))
    theta2_nz = torch.where(near_zero, one, theta2)
    theta3_nz = theta_nz * theta2_nz

    # theta_nz is theta wherever the non-series branch reads it
    sine = torch.sin(theta_nz)
    cosine = torch.where(near_zero, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta_nz))
    sine_by_theta = torch.where(near_zero, 0.5 * cosine + 0.5, sine / theta_nz)
    omc_by_theta2 = torch.where(near_zero, 0.5 * sine_by_theta, (1.0 - cosine) / theta2_nz)

    outer = ang[..., :, None] * ang[..., None, :]
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device)
    rot = (omc_by_theta2[..., None, None] * outer + cosine[..., None, None] * eye
           + sine_by_theta[..., None, None] * _skew(ang))

    sbt_t = torch.where(near_zero, 1.0 - theta2 / 6.0, sine_by_theta)
    omc_t = torch.where(near_zero, 0.5 - theta2 / 24.0, omc_by_theta2)
    tms_t = torch.where(near_zero, 1.0 / 6.0 - theta2 / 120.0,
                        (theta_nz - sine) / theta3_nz)
    trans = (sbt_t[..., None] * lin + omc_t[..., None] * torch.linalg.cross(ang, lin)
             + tms_t[..., None] * ang * torch.sum(ang * lin, dim=-1, keepdim=True))
    return torch.cat([rot, trans[..., None]], dim=-1)


def multiply_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] x [..., 3, 4] -> [..., 3, 4]."""
    rot = a[..., :3, :3] @ b[..., :3, :3]
    t = a[..., :3, 3:] + a[..., :3, :3] @ b[..., :3, 3:]
    return torch.cat([rot, t], dim=-1)
