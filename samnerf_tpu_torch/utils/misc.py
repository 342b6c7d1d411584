"""Small helpers shared across the package.

Counterpart of ``samnerf_tpu/utils/misc.py``: ``step_check``,
``intersect_aabb`` (the viewer's crop box in
:func:`samnerf_tpu_torch.core.cameras.generate_rays`), ``safe_normalize``
and ``scale_dict``; and ``device_constant``, a constant tensor a CUDA
graph can read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept: a CUDA graph cannot capture the host
    to card copy that makes it, and the eager run before a capture has
    made it already.  Read only."""
    a = np.asarray(values)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(a, dtype=dtype, device=device)
    return t


def step_check(step: int, step_size: int, run_at_zero: bool = False) -> bool:
    """True every ``step_size`` steps (never for 0), at step 0 only with
    ``run_at_zero``."""
    if step_size == 0:
        return False
    return (run_at_zero or step != 0) and step % step_size == 0


def intersect_aabb(origins: torch.Tensor, directions: torch.Tensor,
                   aabb: torch.Tensor, max_bound: float = 1e10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/box intersection: origins, directions [..., 3], aabb
    [6] (min xyz, max xyz) -> t_min, t_max [..., 1], each clamped to [0,
    max_bound]; a miss gives t_min > t_max."""
    inv = 1.0 / torch.where(directions.abs() < 1e-10, 1e-10, directions)
    t0 = (aabb[:3] - origins) * inv
    t1 = (aabb[3:] - origins) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    return tmin.clamp(0.0, max_bound), tmax.clamp(0.0, max_bound)


def safe_normalize(v: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def scale_dict(d: Dict[str, torch.Tensor], scales: Dict[str, float]):
    """Each entry times its scale in ``scales`` (1 when absent)."""
    return {k: v * scales.get(k, 1.0) for k, v in d.items()}
