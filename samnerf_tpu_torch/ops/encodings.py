"""Hash-grid level scalings and the spherical-harmonics direction encoding.

Counterpart of ``samnerf_tpu/ops/encodings.py`` (``hash_grid_scalings``
:37, ``sh_encoding`` :181); the flat hash grid there is not on the serve
path and waits.
"""
from __future__ import annotations

import numpy as np
import torch


def hash_grid_scalings(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level grid resolutions (``encodings.py:252-254`` in the reference)."""
    if num_levels == 1:
        return np.array([float(min_res)])
    growth = np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
    return np.floor(min_res * growth ** np.arange(num_levels))


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH components up to ``levels`` (16 outputs for levels=4) of
    unit directions [..., 3]."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [-0.48860251190291987 * y,
                  0.48860251190291987 * z,
                  -0.48860251190291987 * x]
    if levels > 2:
        comps += [1.0925484305920792 * x * y,
                  -1.0925484305920792 * y * z,
                  0.94617469575755997 * zz - 0.31539156525251999,
                  -1.0925484305920792 * x * z,
                  0.54627421529603959 * (xx - yy)]
    if levels > 3:
        comps += [0.59004358992664352 * y * (-3.0 * xx + yy),
                  2.8906114426405538 * x * y * z,
                  0.45704579946446572 * y * (1.0 - 5.0 * zz),
                  0.3731763325901154 * z * (5.0 * zz - 3.0),
                  0.45704579946446572 * x * (1.0 - 5.0 * zz),
                  1.4453057213202769 * z * (xx - yy),
                  0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(comps, dim=-1)
