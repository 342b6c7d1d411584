"""COLMAP sparse models: read ``cameras`` / ``images`` (binary or text)
and write nerfstudio's ``transforms.json``.

The port's copy of ``samnerf_tpu/preprocessing/colmap_utils.py`` (host
numpy, no COLMAP binary needed to read a reconstruction): COLMAP's
world-to-camera quaternions become camera-to-world matrices in
nerfstudio's axes (OpenGL, y up, -z forward), with each camera model's
intrinsics and OpenCV distortion (k1 k2 k3 k4 p1 p2).
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# COLMAP camera model ids (colmap/src/base/camera_models.h)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5), 4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    qvec: np.ndarray  # [4] w x y z
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{n_params}d",
                                            f.read(8 * n_params)))
            cams[cid] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            iid = struct.unpack("<I", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            num_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * num_pts)  # skip 2D points
            images[iid] = ColmapImage(qvec, tvec, cam_id, name.decode())
    return images


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            parts[1], int(parts[2]), int(parts[3]),
            np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    images = {}
    # lines alternate (pose, 2D-points); the points line may be EMPTY, so
    # pair by state rather than filtering blanks and striding by 2
    expecting_pose = True
    for line in Path(path).read_text().splitlines():
        if line.startswith("#"):
            continue
        if expecting_pose:
            if not line.strip():
                continue
            p = line.split()
            images[int(p[0])] = ColmapImage(
                np.array([float(x) for x in p[1:5]]),
                np.array([float(x) for x in p[5:8]]), int(p[8]), p[9])
            expecting_pose = False
        else:
            expecting_pose = True
    return images


def _intrinsics(cam: ColmapCamera) -> Tuple[dict, np.ndarray]:
    p = cam.params
    out = {"w": cam.width, "h": cam.height}
    dist = np.zeros(6)
    if cam.model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif cam.model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif cam.model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
        dist[0] = p[3]
    elif cam.model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
        dist[0], dist[1] = p[3], p[4]
    elif cam.model in ("OPENCV", "OPENCV_FISHEYE"):
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
        dist[:4] = p[4:8] if cam.model == "OPENCV_FISHEYE" else \
            [p[4], p[5], 0.0, 0.0]
        if cam.model == "OPENCV":
            dist[4], dist[5] = p[6], p[7]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return out, dist


def colmap_to_json(recon_dir: Path, output_dir: Path,
                   image_dir_name: str = "images") -> int:
    """Convert a COLMAP sparse reconstruction into transforms.json
    (``colmap_utils.py`` colmap_to_json semantics).

    Returns the number of registered frames.
    """
    recon_dir = Path(recon_dir)
    if (recon_dir / "cameras.bin").exists():
        cams = read_cameras_binary(recon_dir / "cameras.bin")
        images = read_images_binary(recon_dir / "images.bin")
    else:
        cams = read_cameras_text(recon_dir / "cameras.txt")
        images = read_images_text(recon_dir / "images.txt")

    frames = []
    shared = None
    for iid in sorted(images):
        im = images[iid]
        rot = qvec2rotmat(im.qvec)
        t = im.tvec.reshape(3, 1)
        w2c = np.concatenate([np.concatenate([rot, t], 1),
                              np.array([[0, 0, 0, 1.0]])], 0)
        c2w = np.linalg.inv(w2c)
        # COLMAP (OpenCV, +z forward, y down) -> nerfstudio (OpenGL):
        c2w[0:3, 1:3] *= -1
        # and world axes: x->y, y->x... (colmap_to_json: swap + flip z)
        c2w = c2w[np.array([1, 0, 2, 3]), :]
        c2w[2, :] *= -1
        intr, dist = _intrinsics(cams[im.camera_id])
        shared = intr | {"k1": dist[0], "k2": dist[1], "k3": dist[2],
                         "k4": dist[3], "p1": dist[4], "p2": dist[5]}
        frames.append({
            "file_path": f"{image_dir_name}/{im.name}",
            "transform_matrix": c2w.tolist(),
        })
    out = dict(shared or {})
    out["camera_model"] = "OPENCV"
    out["frames"] = frames
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    return len(frames)
