"""Precomputed feature maps (distillation targets) as one host array.

Counterpart of ``samnerf_tpu/data/feature_loader.py``: every per-image map
goes into one ``[n, h, w, c]`` float32 numpy array, which
:func:`samnerf_tpu_torch.data.device_data.build_device_dataset` moves to
the card; lookups happen there (``device_data.lookup_features``).  SAM
maps are ``.npy`` [c, h, w]; DINO maps are ``.pt`` tensors [h, w, c];
ClipSeg maps are ``.pt`` activation dicts.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def load_features(paths: Sequence[str],
                  get_feature: Optional[Callable] = None) -> np.ndarray:
    """The maps of ``paths`` stacked as [n, h, w, c] float32."""
    feats = []
    for p in map(str, paths):
        if p.endswith(".npy"):
            f = np.moveaxis(np.load(p), 0, -1)              # c h w -> h w c
        elif p.endswith(".pt"):
            f = torch.load(p, map_location="cpu", weights_only=False)
            f = get_feature(f) if get_feature is not None else f
            if isinstance(f, torch.Tensor):
                f = f.detach().numpy()
        else:
            raise ValueError(f"unsupported feature file {p}")
        feats.append(np.asarray(f, dtype=np.float32))
    return np.stack(feats, axis=0)


def clipseg_pt_to_grid(obj) -> np.ndarray:
    """A saved ClipSeg activation dict -> 32x32x192: the 3 reduced
    activations concatenated, the CLS token dropped."""
    acts = torch.cat(obj["activations"], dim=-1).squeeze()[1:, ...]
    return acts.reshape(512 // 16, 512 // 16, -1).numpy()
