"""Nerfstudio-format dataparser: ``transforms_{train,test}.json`` or
``transforms.json`` -> cameras and scene box (host numpy, then torch).

Counterpart of ``samnerf_tpu/data/dataparser.py`` (``parse_nerfstudio_data``
with ``auto_orient_and_center_poses``): pinhole intrinsics shared or per
frame, and OpenCV distortion (``k1 k2 k3 k4 p1 p2``) shared at the top of
the file or per frame, as the JAX package reads them (the top level counts
as shared when it names any of ``k1 k2 k3 p1 p2``; all-zero parameters
give undistorted cameras).  The other formats are parsed by
:mod:`samnerf_tpu_torch.data.dataparsers_extra`.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras

MAX_AUTO_RESOLUTION = 1600
_DISTORTION = ("k1", "k2", "k3", "k4", "p1", "p2")


@dataclasses.dataclass
class DataparserConfig:
    data: Path = Path("data")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"  # 'up' | 'none'
    center_poses: bool = True
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    train_val_json_split: bool = False


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    cameras: Cameras  # CPU tensors
    scene_box_aabb: np.ndarray  # [2, 3]
    dataparser_scale: float
    dataparser_transform: np.ndarray  # [3, 4]
    downscale_factor: int = 1
    mask_filenames: Optional[List[Path]] = None


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rodrigues rotation taking a to b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        eps = (np.random.rand(3) - 0.5) * 0.01
        return _rotation_between(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s ** 2 + 1e-8))


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_poses: bool = True):
    """Rotate the mean up vector to +z ('up') or only translate ('none')."""
    mean_translation = poses[..., :3, 3].mean(axis=0)
    translation = mean_translation if center_poses else np.zeros(3)
    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=-1)
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
    else:
        raise ValueError(method)
    return transform @ poses, transform


def parse_nerfstudio_data(config: DataparserConfig,
                          split: str = "train") -> DataparserOutputs:
    data = Path(config.data)
    num_train_images = None
    if data.suffix == ".json":
        meta = json.loads(data.read_text())
        data_dir = data.parent
    elif config.train_val_json_split:
        meta = json.loads((data / "transforms_train.json").read_text())
        meta_val = json.loads((data / "transforms_test.json").read_text())
        num_train_images = len(meta["frames"])
        meta["frames"] = list(meta["frames"]) + list(meta_val["frames"])
        data_dir = data
    else:
        meta = json.loads((data / "transforms.json").read_text())
        data_dir = data

    intrinsics = ("fl_x", "fl_y", "cx", "cy", "h", "w")
    per_frame = {k: [] for k in intrinsics if k not in meta}
    distort_fixed = any(k in meta for k in ("k1", "k2", "k3", "p1", "p2"))

    def frame_dist(src):
        return np.array([float(src.get(k, 0.0)) for k in _DISTORTION], np.float32)

    image_filenames, poses, dists = [], [], []
    for frame in meta["frames"]:
        fp = Path(frame["file_path"])
        image_filenames.append(fp if fp.is_absolute() else data_dir / fp)
        poses.append(np.array(frame["transform_matrix"], np.float32))
        for k in per_frame:
            per_frame[k].append(float(frame[k]))
        if not distort_fixed:
            dists.append(frame_dist(frame))

    num_images = len(image_filenames)
    if config.train_val_json_split:
        i_train = np.arange(num_train_images)
    else:
        num_train = math.ceil(num_images * config.train_split_fraction)
        i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(num_images), i_train)
    indices = i_train if split == "train" else i_eval

    poses, transform = auto_orient_and_center_poses(
        np.stack(poses, axis=0), method=config.orientation_method,
        center_poses=config.center_poses)
    scale = 1.0
    if config.auto_scale_poses:
        scale /= float(np.max(np.abs(poses[:, :3, 3])))
    scale *= config.scale_factor
    poses[:, :3, 3] *= scale
    poses = poses[indices]

    def pick(key):
        if key in meta:
            return np.full((len(indices), 1), float(meta[key]), np.float32)
        return np.asarray(per_frame[key], np.float32)[indices][:, None]

    height = int(meta["h"]) if "h" in meta else int(per_frame["h"][indices[0]])
    width = int(meta["w"]) if "w" in meta else int(per_frame["w"][indices[0]])
    df = config.downscale_factor
    if df is None:
        df = 1
        while max(height, width) / df > MAX_AUTO_RESOLUTION:
            df *= 2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    if distort_fixed:
        dist = np.tile(frame_dist(meta)[None], (len(indices), 1))
    else:
        dist = np.stack(dists, axis=0)[indices]
    cameras = Cameras(
        camera_to_worlds=t(poses[:, :3, :4]), fx=t(pick("fl_x")), fy=t(pick("fl_y")),
        cx=t(pick("cx")), cy=t(pick("cy")), width=width, height=height,
        distortion_params=t(dist) if dist.any() else None)
    if df > 1:
        cameras = cameras.rescale_output_resolution(1.0 / df)
    return DataparserOutputs(
        image_filenames=[image_filenames[i] for i in indices], cameras=cameras,
        scene_box_aabb=np.array([[-config.scene_scale] * 3,
                                 [config.scene_scale] * 3], np.float32),
        dataparser_scale=scale, dataparser_transform=transform,
        downscale_factor=df)
