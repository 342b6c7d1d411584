"""Camera trajectories for offline rendering (``scripts/render.py``).

Counterpart of ``samnerf_tpu/core/camera_paths.py``: the viewer's saved
camera path (``get_path_from_json``), a slerp path through dataset
cameras (``get_interpolated_camera_path``) and a spiral around one camera
(``get_spiral_path``).  Poses are built in numpy on the host; the
returned ``Cameras`` lie on the CPU (``.to(device)`` moves them).  A
saved path's ``camera_type`` (perspective, fisheye or equirectangular)
goes into the cameras, whose rays follow it
(:func:`samnerf_tpu_torch.core.cameras.generate_rays`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import EQUIRECTANGULAR, FISHEYE, PERSPECTIVE, Cameras


def three_js_perspective_camera_focal_length(fov_deg: float, image_height: int) -> float:
    """three.js vertical field of view (degrees) -> focal length in
    pixels; 50 without one."""
    if fov_deg is None:
        return 50.0
    return (image_height / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)


def _rot_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (w, x, y, z) unit quaternion."""
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([0.25 / s, (m[2, 1] - m[1, 2]) * s,
                         (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quaternion_slerp(q0: np.ndarray, q1: np.ndarray, fraction: float) -> np.ndarray:
    """Shortest-path spherical interpolation of unit quaternions."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    if fraction <= 0.0:
        return q0
    if fraction >= 1.0:
        return q1
    d = float(np.dot(q0, q1))
    if d < 0.0:
        d, q1 = -d, -q1
    if abs(abs(d) - 1.0) < 1e-8:
        return q0
    angle = np.arccos(np.clip(d, -1.0, 1.0))
    if abs(angle) < 1e-8:
        return q0
    isin = 1.0 / np.sin(angle)
    return (np.sin((1.0 - fraction) * angle) * isin * q0
            + np.sin(fraction * angle) * isin * q1)


def get_interpolated_poses(pose_a: np.ndarray, pose_b: np.ndarray,
                           steps: int = 10) -> np.ndarray:
    """[steps, 3, 4] poses from a towards b (b excluded): slerped rotation,
    linear translation."""
    qa = _rot_to_quat(pose_a[:3, :3])
    qb = _rot_to_quat(pose_b[:3, :3])
    out = []
    for t in np.linspace(0.0, 1.0, steps, endpoint=False):
        r = _quat_to_rot(quaternion_slerp(qa, qb, float(t)))
        trans = (1.0 - t) * pose_a[:3, 3] + t * pose_b[:3, 3]
        out.append(np.concatenate([r, trans[:, None]], axis=1))
    return np.stack(out)


def _cameras(poses: np.ndarray, fx, fy, cx, cy, width: int, height: int,
             camera_type: Optional[int] = None) -> Cameras:
    """Host ``Cameras`` from [N, 3, 4] poses and per-camera (or shared)
    intrinsics, of one ``camera_type`` when given."""
    n = poses.shape[0]

    def col(v):
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (n,)).copy())[:, None]

    return Cameras(camera_to_worlds=torch.as_tensor(poses.astype(np.float32)),
                   fx=col(fx), fy=col(fy), cx=col(cx), cy=col(cy),
                   width=int(width), height=int(height),
                   camera_type=(None if camera_type is None else
                                torch.full((n, 1), camera_type, dtype=torch.int32)))


def get_interpolated_camera_path(cameras: Cameras, steps: int) -> Cameras:
    """A path through every camera in order: ``steps`` poses per pair,
    focal lengths interpolated linearly, the first camera's centre."""
    poses = cameras.camera_to_worlds.cpu().numpy()
    if poses.shape[0] < 2:
        return cameras
    fx = cameras.fx[:, 0].cpu().numpy()
    fy = cameras.fy[:, 0].cpu().numpy()
    all_poses, all_fx, all_fy = [], [], []
    for a in range(poses.shape[0] - 1):
        all_poses.append(get_interpolated_poses(poses[a], poses[a + 1], steps))
        ts = np.linspace(0.0, 1.0, steps, endpoint=False)
        all_fx.append((1 - ts) * fx[a] + ts * fx[a + 1])
        all_fy.append((1 - ts) * fy[a] + ts * fy[a + 1])
    return _cameras(np.concatenate(all_poses), np.concatenate(all_fx),
                    np.concatenate(all_fy), float(cameras.cx[0, 0]),
                    float(cameras.cy[0, 0]), cameras.width, cameras.height)


def _viewmatrix(lookat: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Camera-to-world looking along ``lookat`` (the camera looks down -z)."""
    vec2 = lookat / np.linalg.norm(lookat)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def get_spiral_path(camera: Cameras, steps: int = 30, radius: Optional[float] = None,
                    radiuses: Optional[Tuple[float, ...]] = None, rots: int = 2,
                    zrate: float = 0.5) -> Cameras:
    """``steps`` poses on a spiral around the first camera of ``camera``,
    its intrinsics; exactly one of ``radius`` / ``radiuses`` (per axis)."""
    if (radius is None) == (radiuses is None):
        raise ValueError("give exactly one of radius and radiuses")
    rad = np.array([radius] * 3 if radius is not None else radiuses)
    c2w = camera.camera_to_worlds[0].cpu().numpy()
    up = c2w[:3, 2]
    fx, fy = float(camera.fx[0, 0]), float(camera.fy[0, 0])
    target = np.array([0.0, 0.0, -min(fx, fy)])
    c2wh = np.eye(4)
    c2wh[:3] = c2w
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, steps + 1)[:-1]:
        center = np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate)]) * rad
        local = np.eye(4)
        local[:3] = _viewmatrix(center - target, up, center)
        out.append((c2wh @ local)[:3])
    return _cameras(np.stack(out), fx, fy, float(camera.cx[0, 0]), float(camera.cy[0, 0]),
                    camera.width, camera.height)


def get_path_from_json(camera_path: Dict[str, Any]) -> Cameras:
    """The viewer's saved camera path (``render_height``, ``render_width``,
    ``camera_path``: keyframes of a row-major 4x4 ``camera_to_world`` and a
    ``fov``, and a ``camera_type``) -> ``Cameras`` centred on the image.
    An equirectangular path takes fx = width / 2 and fy = height; an
    unknown type is perspective."""
    h = int(camera_path["render_height"])
    w = int(camera_path["render_width"])
    kind = camera_path.get("camera_type", "perspective")
    ctype = {"perspective": PERSPECTIVE, "fisheye": FISHEYE,
             "equirectangular": EQUIRECTANGULAR}.get(kind, PERSPECTIVE)
    c2ws, fxs, fys = [], [], []
    for cam in camera_path["camera_path"]:
        c2ws.append(np.asarray(cam["camera_to_world"], np.float32).reshape(4, 4)[:3])
        if ctype == EQUIRECTANGULAR:
            fxs.append(w / 2.0)
            fys.append(float(h))
        else:
            f = three_js_perspective_camera_focal_length(cam.get("fov"), h)
            fxs.append(f)
            fys.append(f)
    return _cameras(np.stack(c2ws), np.asarray(fxs, np.float32), np.asarray(fys, np.float32),
                    w / 2.0, h / 2.0, w, h, camera_type=ctype)
