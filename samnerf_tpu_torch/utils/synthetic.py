"""Synthetic scene: a red ball on a white background, cameras on a circle,
with SAM and ClipSeg feature maps.

The port's copy of ``samnerf_tpu/utils/synthetic.py:write_scene`` and the
helpers it needs.  On-disk layout: ``transforms_{train,test}.json``,
``images/``, ``sam_features/*.npy`` ([256, fh, fw]) and
``clipseg_features/*.pt`` (three [1025, 1, 64] activations).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from PIL import Image

BALL_RADIUS = 0.35
BALL_COLOR = np.array([0.8, 0.25, 0.2])
BG_COLOR = np.array([1.0, 1.0, 1.0])


def look_at_c2w(position: np.ndarray, target: np.ndarray,
                up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """OpenGL camera-to-world (the camera looks along -z)."""
    forward = target - position
    z = -forward / np.linalg.norm(forward)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, position
    return c2w


def ray_sphere_hit(origins, directions, radius=BALL_RADIUS):
    """Hit mask and depth of rays against the ball at the origin."""
    b = np.sum(origins * directions, axis=-1)
    c = np.sum(origins * origins, axis=-1) - radius ** 2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    return hit, np.where(hit, t, 1e6)


def render_gt_image(c2w, fx, fy, cx, cy, h, w):
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack([(xx - cx) / fx, -(yy - cy) / fy, -np.ones_like(xx)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    hit, _ = ray_sphere_hit(origins.reshape(-1, 3), dirs.reshape(-1, 3))
    hit = hit.reshape(h, w)
    img = np.where(hit[..., None], BALL_COLOR, BG_COLOR)
    return (img * 255).astype(np.uint8), hit


def write_scene(out_dir: Path, num_train: int = 8, num_test: int = 2,
                h: int = 64, w: int = 64, radius: float = 2.0,
                with_features: bool = False,
                feature_long_side: int = 16) -> Path:
    """Write a complete samnerf-format scene; returns the scene dir."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    if with_features:
        (out_dir / "sam_features").mkdir(exist_ok=True)
        (out_dir / "clipseg_features").mkdir(exist_ok=True)
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    n_total = num_train + num_test
    frames = []
    for i in range(n_total):
        ang = 2 * np.pi * i / n_total
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.8])
        c2w = look_at_c2w(pos, np.zeros(3))
        img, hit = render_gt_image(c2w, fx, fy, cx, cy, h, w)
        name = f"frame_{i:05d}.png"
        Image.fromarray(img).save(out_dir / "images" / name)
        frames.append({"file_path": f"images/{name}", "transform_matrix": c2w.tolist()})
        if with_features:
            # SAM: +1 inside the ball, -1 outside, on every channel
            fh = int(np.ceil(h / w * feature_long_side)) if h < w else feature_long_side
            fw = feature_long_side if h <= w else int(np.ceil(w / h * feature_long_side))
            ys = np.linspace(0, h - 1, fh).astype(int)
            xs = np.linspace(0, w - 1, fw).astype(int)
            feat = np.where(hit[np.ix_(ys, xs)][None], 1.0, -1.0) * np.ones((256, 1, 1))
            np.save(out_dir / "sam_features" / f"frame_{i:05d}.npy",
                    feat.astype(np.float32))
            # ClipSeg: 3 activations [1025, 1, 64], token 0 the CLS token
            ys32 = np.linspace(0, h - 1, 32).astype(int)
            xs32 = np.linspace(0, w - 1, 32).astype(int)
            g = hit[np.ix_(ys32, xs32)].astype(np.float32) * 2 - 1
            acts = [torch.from_numpy(np.concatenate(
                [np.zeros((1, 1, 64), np.float32),
                 np.repeat(g.reshape(1024, 1, 1), 64, axis=2)])) for _ in range(3)]
            torch.save({"activations": acts, "visual_q": None},
                       out_dir / "clipseg_features" / f"frame_{i:05d}.pt")
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "h": h, "w": w}
    (out_dir / "transforms_train.json").write_text(
        json.dumps(dict(meta, frames=frames[:num_train])))
    (out_dir / "transforms_test.json").write_text(
        json.dumps(dict(meta, frames=frames[num_train:])))
    return out_dir
