"""DataManager: a scene's cameras, images and precomputed features.

Counterpart of ``samnerf_tpu/data/datamanager.py``.  The scene's format
picks its parser as in the JAX package (:func:`_detect_parser`): a Blender
scene (``transforms_train.json`` with ``camera_angle_x`` and no
``fl_x``) and an instant-ngp one (``transforms.json`` with ``aabb_scale``
and no ``fl_x``) go to :mod:`samnerf_tpu_torch.data.dataparsers_extra`,
the rest to the nerfstudio parser.  All images are decoded once into one
uint8 numpy array and each feature set (SAM, DINO, ClipSeg) into one
float32 array; they stay in host memory until
:func:`samnerf_tpu_torch.data.device_data.build_device_dataset` moves the
whole set to the card, where the trainer samples every batch.  The JAX
package's host batch path for training (``next_train``) is not ported.
The eval split is sampled on the host, as the JAX package samples it:
:meth:`DataManager.next_eval` draws from a ``numpy.random.Generator``
seeded like the JAX DataManager's, with the same arithmetic
(:func:`sample_uniform`), so one seed gives the JAX package's indices.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image

from samnerf_tpu_torch.data.dataparser import DataparserConfig, parse_nerfstudio_data
from samnerf_tpu_torch.data.feature_loader import clipseg_pt_to_grid, load_features


@dataclasses.dataclass
class DataManagerConfig:
    dataparser: DataparserConfig = dataclasses.field(default_factory=DataparserConfig)
    train_num_rays_per_batch: int = 4096 * 4
    eval_num_rays_per_batch: int = 4096 * 4
    patch_size: int = 1
    distill_sam: bool = False
    use_dino_feature: bool = False
    use_clipseg_feature: bool = False


def _load_image(path: Path, downscale: int) -> np.ndarray:
    """uint8 [H, W, 3]; alpha composited over white; honours nerfstudio's
    ``images_<d>/`` directories."""
    path = Path(path)
    if downscale > 1:
        cand = path.parent.parent / f"{path.parent.name}_{downscale}" / path.name
        if cand.exists():
            path = cand
    img = Image.open(path)
    if img.mode in ("RGBA", "LA", "PA") or (
            img.mode == "P" and "transparency" in img.info):
        rgba = img.convert("RGBA")
        bg = Image.new("RGBA", rgba.size, (255, 255, 255, 255))
        img = Image.alpha_composite(bg, rgba).convert("RGB")
    else:
        img = img.convert("RGB")
    if downscale > 1 and "images_" not in path.parent.name:
        img = img.resize((img.width // downscale, img.height // downscale),
                         Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def sample_uniform(rng: np.random.Generator, batch_size: int, num_images: int,
                   height: int, width: int) -> np.ndarray:
    """[B, 3] int32 (img, row, col), uniform over the split's pixels."""
    u = rng.random((batch_size, 3))
    idx = np.floor(u * np.array([num_images, height, width])).astype(np.int32)
    return idx


def _family_config(cls, dp_config):
    """A family parser's config carrying every field of the user's
    ``DataparserConfig`` that it shares by name (``data``, ``scale_factor``,
    ...), so routing keeps the user's overrides."""
    return cls(**{f.name: getattr(dp_config, f.name) for f in dataclasses.fields(cls)
                  if hasattr(dp_config, f.name)})


def _read_json(path: Path) -> dict:
    """The file's JSON object, or {} when it cannot be read or parsed."""
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def _detect_parser(dp_config):
    """The parse function for the scene at ``dp_config.data``, by its files:
    Blender, instant-ngp, else nerfstudio."""
    from samnerf_tpu_torch.data import dataparsers_extra as extra

    data = Path(dp_config.data)
    tt = data / "transforms_train.json"
    if tt.exists():
        meta = _read_json(tt)
        if "camera_angle_x" in meta and "fl_x" not in meta:
            return lambda cfg, split: extra.parse_blender_data(
                _family_config(extra.BlenderDataparserConfig, cfg), split=split)
    tj = data / "transforms.json"
    if tj.exists():
        meta = _read_json(tj)
        if "aabb_scale" in meta and "fl_x" not in meta:
            return lambda cfg, split: extra.parse_instant_ngp_data(
                _family_config(extra.InstantNGPDataparserConfig, cfg), split=split)
    return parse_nerfstudio_data


class DataManager:
    def __init__(self, config: DataManagerConfig, seed: int = 0, load_images: bool = True):
        """``load_images=False`` leaves ``images`` and ``eval_images`` None
        (a subclass that keeps its own, as ``VariableResDataManager``)."""
        self.config = config
        self.rng = np.random.default_rng(seed)
        dp = config.dataparser
        parse = _detect_parser(dp)
        self.train_outputs = parse(dp, split="train")
        self.eval_outputs = parse(dp, split="test")
        self.cameras = self.train_outputs.cameras
        self.eval_cameras = self.eval_outputs.cameras

        def load_split(outputs):
            return np.stack([_load_image(p, outputs.downscale_factor)
                             for p in outputs.image_filenames])

        self.images = self.eval_images = None
        if load_images:
            self.images = load_split(self.train_outputs)
            self.eval_images = (load_split(self.eval_outputs)
                                if self.eval_outputs.image_filenames else None)
        # [n, fh, fw, c] float32, or None when the config does not use them
        self.sam_features = self.dino_features = self.clipseg_features = None
        names = self.train_outputs.image_filenames
        if config.distill_sam:
            self.sam_features = load_features(
                [self._sibling(p, "sam_features", ".npy") for p in names])
        if config.use_dino_feature:
            self.dino_features = load_features(
                [self._sibling(p, "dino_features", ".pt") for p in names])
        if config.use_clipseg_feature:
            self.clipseg_features = load_features(
                [self._sibling(p, "clipseg_features", ".pt") for p in names],
                get_feature=clipseg_pt_to_grid)

    @staticmethod
    def _sibling(image_path: Path, subdir: str, ext: str) -> str:
        """``<data>/<subdir>/<stem><ext>``."""
        p = Path(image_path)
        return str(p.parent.parent / subdir / (p.stem + ext))

    @property
    def num_train_images(self) -> int:
        return self.images.shape[0]

    def next_eval(self, step: int) -> Dict[str, np.ndarray]:
        """One eval ray batch on the host: indices [B, 3] and rgb targets
        [B, 3] in [0, 1] (the eval split has no feature maps)."""
        h, w = self.eval_cameras.height, self.eval_cameras.width
        indices = sample_uniform(self.rng, self.config.eval_num_rays_per_batch,
                                 self.eval_images.shape[0], h, w)
        image = (self.eval_images[indices[:, 0], indices[:, 1], indices[:, 2]]
                 .astype(np.float32) / 255.0)
        return {"indices": indices, "image": image}

    def eval_image_batch(self, image_index: int) -> Dict[str, np.ndarray]:
        """Every pixel of one eval image: indices [H*W, 3] row-major and the
        image [H, W, 3] in [0, 1]."""
        h, w = self.eval_cameras.height, self.eval_cameras.width
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([yy, xx], -1).reshape(-1, 2).astype(np.int32)
        indices = np.concatenate(
            [np.full((coords.shape[0], 1), image_index, np.int32), coords], -1)
        return {"indices": indices,
                "image": self.eval_images[image_index].astype(np.float32) / 255.0}
