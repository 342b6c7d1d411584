"""Equirectangular panoramas -> perspective crops.

The port's copy of ``samnerf_tpu/preprocessing/equirect_utils.py`` (host
numpy): a direction grid per crop, its longitude and latitude, and a
bilinear lookup in the panorama that wraps horizontally.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np


def equirect_to_perspective(pano: np.ndarray, fov_deg: float, yaw: float,
                            pitch: float,
                            out_hw: Tuple[int, int]) -> np.ndarray:
    """Sample one perspective view out of an equirectangular panorama.

    pano: [H, W, C] uint8/float; yaw/pitch in radians (yaw: +left around
    +z-up; pitch: +up); fov is horizontal.  Bilinear lookup with
    horizontal wrap, matching equilib's default sampling.
    """
    h, w = out_hw
    fov = np.deg2rad(fov_deg)
    focal = 0.5 * w / np.tan(fov / 2.0)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    # camera frame: x right, y down, z forward
    d = np.stack([(xx - w / 2.0) / focal, (yy - h / 2.0) / focal,
                  np.ones_like(xx)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cyaw, syaw = np.cos(yaw), np.sin(yaw)
    rot_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_yaw = np.array([[cyaw, 0, syaw], [0, 1, 0], [-syaw, 0, cyaw]])
    d = d @ (rot_yaw @ rot_pitch).T

    lon = np.arctan2(d[..., 0], d[..., 2])          # [-pi, pi]
    lat = np.arcsin(np.clip(d[..., 1], -1, 1))      # [-pi/2, pi/2]
    ph, pw = pano.shape[:2]
    u = (lon / (2 * np.pi) + 0.5) * pw - 0.5
    v = (lat / np.pi + 0.5) * ph - 0.5

    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0w = u0 % pw
    u1w = (u0 + 1) % pw
    v0c = np.clip(v0, 0, ph - 1)
    v1c = np.clip(v0 + 1, 0, ph - 1)
    p = pano.astype(np.float32)
    out = ((1 - du) * (1 - dv) * p[v0c, u0w]
           + du * (1 - dv) * p[v0c, u1w]
           + (1 - du) * dv * p[v1c, u0w]
           + du * dv * p[v1c, u1w])
    return out.astype(pano.dtype)


def compute_resolution_from_equirect(image_dir: Path,
                                     num_images: int) -> Tuple[int, int]:
    """Perspective crop size so ``num_images`` crops roughly tile the
    panorama at native pixel density (``equirect_utils.py:195-230``)."""
    from PIL import Image
    first = sorted(Path(image_dir).iterdir())[0]
    with Image.open(first) as im:
        pw, ph = im.size
    # each crop covers ~(360/sqrt(2N))^2 degrees; preserve pixel density
    per_side = int(np.ceil(np.sqrt(num_images * 2)))
    fov = 360.0 / per_side
    side = int(round(pw * fov / 360.0))
    return side, side


def generate_planar_projections_from_equirectangular(
        image_dir: Path, planar_image_size: Tuple[int, int],
        samples_per_im: int, fov_deg: float = 90.0,
        percent_crop: Tuple[float, float, float, float] = (0, 0, 0, 0)
        ) -> Path:
    """Write ``samples_per_im`` perspective crops per panorama into
    ``<image_dir>/planar_projections`` plus a ``projections.json`` with
    each crop's yaw/pitch/fov (``equirect_utils.py:108-192``).

    Yaw is sampled uniformly; pitch alternates between two rings whose
    extent shrinks with the (top, bottom) crop percentages.
    """
    from PIL import Image
    image_dir = Path(image_dir)
    out_dir = image_dir / "planar_projections"
    out_dir.mkdir(exist_ok=True)
    w, h = planar_image_size
    top_lim = -np.pi / 2 + np.pi * percent_crop[0]
    bot_lim = np.pi / 2 - np.pi * percent_crop[1]

    n_yaw = max(1, int(np.ceil(samples_per_im / 2)))
    pitches = [max(top_lim, -np.pi / 8), min(bot_lim, np.pi / 8)]
    meta = []
    for img_path in sorted(p for p in image_dir.iterdir() if p.is_file()):
        try:
            pano = np.asarray(Image.open(img_path).convert("RGB"))
        except Exception:  # noqa: BLE001 — not an image
            continue
        count = 0
        for pi, pitch in enumerate(pitches):
            for yi in range(n_yaw):
                if count >= samples_per_im:
                    break
                yaw = 2 * np.pi * yi / n_yaw + pi * np.pi / n_yaw
                crop = equirect_to_perspective(pano, fov_deg, yaw, -pitch,
                                               (h, w))
                name = f"{img_path.stem}_p{count:03d}.png"
                Image.fromarray(crop).save(out_dir / name)
                # record the pitch actually rendered (-pitch is what
                # equirect_to_perspective received) so pose reconstruction
                # from projections.json matches the crops
                meta.append({"file_path": name, "source": img_path.name,
                             "yaw": yaw, "pitch": float(-pitch),
                             "fov": fov_deg})
                count += 1
    (out_dir / "projections.json").write_text(json.dumps(meta, indent=2))
    return out_dir
