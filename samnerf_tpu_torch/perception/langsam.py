"""Mask overlays of ``samnerf_tpu/perception/langsam.py`` (``show_mask``,
``composite_mask``), numpy only.  ``LanguageSAM`` waits for ClipSeg."""
from __future__ import annotations

from typing import Optional

import numpy as np


def show_mask(mask: np.ndarray, rng: Optional[np.random.Generator] = None,
              random_color: bool = False) -> np.ndarray:
    """[h, w] bool -> RGBA overlay: a random color from ``rng`` or SAM's
    blue, at alpha 0.6."""
    if random_color:
        rng = rng or np.random.default_rng()
        color = np.concatenate([rng.random(3), [0.6]])
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255, 0.6])
    return mask[..., None] * color[None, None]


def composite_mask(mask: np.ndarray, image: np.ndarray,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Blend a random mask color over ``image`` [h, w, 3] in [0, 1]."""
    m = show_mask(mask, rng=rng, random_color=True)
    return m[..., :3] * m[..., 3:] + image * (1 - m[..., 3:])
