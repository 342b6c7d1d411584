"""Depth, semantic and variable-resolution datamanagers, counterpart of
``samnerf_tpu/data/datamanagers_extra.py``.

``DepthDataManager`` and ``SemanticDataManager`` load one extra
per-pixel channel per training image; :func:`samnerf_tpu_torch.data
.device_data.build_device_dataset` puts it on the card beside the images
and :func:`~samnerf_tpu_torch.data.device_data.gather_batch` gathers it
at each batch's pixels as ``depth_image`` [B, 1] f32 or ``semantics``
[B, 1] int32, where the JAX package attaches them to its host batch
(``next_train``).  ``VariableResDataManager`` keeps ragged images on the
host and samples one image per batch, as the JAX one does (from the same
seeded numpy generator, so one seed gives the JAX package's batches).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig, _load_image


def _load_gray(path: Path, downscale: int, dtype) -> np.ndarray:
    """One channel of an image file: NEAREST-downscaled, the first channel
    of a multi-channel image, as ``dtype``."""
    from PIL import Image
    with Image.open(path) as im:
        if downscale > 1:
            im = im.resize((im.width // downscale, im.height // downscale), Image.NEAREST)
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(dtype)


class DepthDataManager(DataManager):
    """``depths`` [N, H, W] f32 from ``<data>/depths/<stem>.npy``, else
    ``<stem>.png`` (16-bit millimetres) x ``depth_unit_scale_factor``; None
    unless every training image has one."""

    def __init__(self, config: DataManagerConfig, seed: int = 0,
                 depth_unit_scale_factor: float = 1e-3):
        super().__init__(config, seed=seed)
        self.depth_unit_scale_factor = depth_unit_scale_factor
        self.depths: Optional[np.ndarray] = None
        depths: List[np.ndarray] = []
        for p in self.train_outputs.image_filenames:
            npy = Path(self._sibling(p, "depths", ".npy"))
            png = Path(self._sibling(p, "depths", ".png"))
            if npy.exists():
                depths.append(np.load(npy).astype(np.float32))
            elif png.exists():
                depths.append(_load_gray(png, self.train_outputs.downscale_factor,
                                         np.float32) * depth_unit_scale_factor)
            else:
                depths = []
                break
        if depths:
            self.depths = np.stack(depths)


class SemanticDataManager(DataManager):
    """``semantics`` [N, H, W] int32 class ids from
    ``<data>/semantics/<stem>.png``; None unless every training image has
    one."""

    def __init__(self, config: DataManagerConfig, seed: int = 0):
        super().__init__(config, seed=seed)
        self.semantics: Optional[np.ndarray] = None
        masks: List[np.ndarray] = []
        for p in self.train_outputs.image_filenames:
            png = Path(self._sibling(p, "semantics", ".png"))
            if not png.exists():
                masks = []
                break
            masks.append(_load_gray(png, self.train_outputs.downscale_factor, np.int32))
        if masks:
            self.semantics = np.stack(masks)


class VariableResDataManager(DataManager):
    """Training images of different sizes, kept as a list (``image_list``);
    each batch draws one image, then its pixels, on the host."""

    def __init__(self, config: DataManagerConfig, seed: int = 0):
        super().__init__(config, seed=seed, load_images=False)
        df = self.train_outputs.downscale_factor
        self.image_list = [_load_image(p, df) for p in self.train_outputs.image_filenames]

    @property
    def num_train_images(self) -> int:
        return len(self.image_list)

    def next_train(self, step: int) -> Dict[str, np.ndarray]:
        """indices [B, 3] int32 (image, row, col) of one image and its rgb
        [B, 3] in [0, 1]."""
        cfg = self.config
        img_idx = int(self.rng.integers(0, len(self.image_list)))
        img = self.image_list[img_idx]
        h, w = img.shape[:2]
        ys = self.rng.integers(0, h, cfg.train_num_rays_per_batch)
        xs = self.rng.integers(0, w, cfg.train_num_rays_per_batch)
        indices = np.stack([np.full_like(ys, img_idx), ys, xs], axis=-1)
        return {"indices": indices.astype(np.int32),
                "image": img[ys, xs].astype(np.float32) / 255.0}
