"""Colormaps for the viewer's one-channel outputs (depth, accumulation,
heatmaps), counterpart of ``samnerf_tpu/utils/colormaps.py``: an 18-stop
turbo table, interpolated linearly.  Host numpy."""
from __future__ import annotations

import numpy as np

_TURBO = np.array([
    [0.18995, 0.07176, 0.23217], [0.25107, 0.25237, 0.63374],
    [0.27628, 0.42118, 0.89123], [0.25862, 0.57958, 0.99876],
    [0.15844, 0.73551, 0.92305], [0.09267, 0.86554, 0.7623],
    [0.19659, 0.94901, 0.59466], [0.42778, 0.99419, 0.38575],
    [0.64362, 0.98999, 0.23356], [0.80473, 0.92452, 0.20459],
    [0.93301, 0.81236, 0.22667], [0.99314, 0.67408, 0.20348],
    [0.99593, 0.49974, 0.11167], [0.95801, 0.33498, 0.05475],
    [0.86601, 0.1981, 0.02365], [0.72393, 0.09907, 0.00851],
    [0.57549, 0.04092, 0.00299], [0.4796, 0.01583, 0.01055],
], np.float32)


def apply_float_colormap(values: np.ndarray) -> np.ndarray:
    """values [..., 1] in [0, 1] -> rgb [..., 3] (turbo)."""
    v = np.clip(values[..., 0], 0.0, 1.0)
    x = v * (len(_TURBO) - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.clip(lo + 1, 0, len(_TURBO) - 1)
    w = (x - lo)[..., None]
    return _TURBO[lo] * (1 - w) + _TURBO[hi] * w


def apply_colormap(values: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] (unless constant), then turbo."""
    v = np.asarray(values, np.float32)
    vmin, vmax = float(v.min()), float(v.max())
    if vmax - vmin > 1e-10:
        v = (v - vmin) / (vmax - vmin)
    return apply_float_colormap(v)


def apply_depth_colormap(depth: np.ndarray, accumulation: np.ndarray = None) -> np.ndarray:
    """Depth normalised between its 5th and 95th percentiles, turbo, then
    scaled by ``accumulation`` when given."""
    d = np.asarray(depth, np.float32)
    near = np.percentile(d, 5)
    far = np.percentile(d, 95)
    d = np.clip((d - near) / max(far - near, 1e-10), 0, 1)
    img = apply_float_colormap(d)
    if accumulation is not None:
        img = img * np.asarray(accumulation, np.float32)
    return img
