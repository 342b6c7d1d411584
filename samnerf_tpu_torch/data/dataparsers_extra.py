"""The other dataparser families: Blender, instant-ngp, D-NeRF, minimal,
phototourism, sdfstudio, ScanNet, ARKitScenes, Dycheck, Sitcoms3D and
nuScenes, and ``dataparser_registry``.

The port's copy of ``samnerf_tpu/data/dataparsers_extra.py`` (host numpy,
then CPU ``Cameras``).  Each parser returns the
:class:`~samnerf_tpu_torch.data.dataparser.DataparserOutputs` of the
nerfstudio parser, so the rest of the port is shared; D-NeRF and Dycheck
also return each frame's time, which no ported model reads yet (the
model zoo's dynamic models do).  :mod:`samnerf_tpu_torch.data.datamanager`
routes Blender and instant-ngp directories here by their files.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.data.dataparser import DataparserOutputs, parse_nerfstudio_data


def _make_cameras(poses: np.ndarray, fx, fy, cx, cy, h: int, w: int) -> Cameras:
    """CPU ``Cameras`` from [N, >=3, 4] poses and shared or per-camera
    intrinsics, all as float32."""
    n = poses.shape[0]

    def as_col(v):
        return torch.from_numpy(np.broadcast_to(
            np.asarray(v, np.float32).reshape(-1, 1), (n, 1)).copy())

    return Cameras(camera_to_worlds=torch.from_numpy(
                       np.ascontiguousarray(poses[:, :3, :4], dtype=np.float32)),
                   fx=as_col(fx), fy=as_col(fy), cx=as_col(cx),
                   cy=as_col(cy), width=int(w), height=int(h))


@dataclasses.dataclass
class BlenderDataparserConfig:
    """``blender_dataparser.py``: NeRF-synthetic transforms_{split}.json."""
    data: Path = Path("data/blender/lego")
    scale_factor: float = 1.0
    alpha_color: str = "white"


def parse_blender_data(config: BlenderDataparserConfig,
                       split: str = "train") -> DataparserOutputs:
    data = Path(config.data)
    meta = json.loads((data / f"transforms_{split}.json").read_text())
    image_filenames: List[Path] = []
    poses = []
    for frame in meta["frames"]:
        fname = frame["file_path"].replace("./", "")
        if not fname.endswith(".png"):
            fname = fname + ".png"
        image_filenames.append(data / fname)
        poses.append(np.array(frame["transform_matrix"], np.float32))
    poses = np.stack(poses)
    # blender probes image size from the first image; fall back to 800
    try:
        from PIL import Image
        with Image.open(image_filenames[0]) as im:
            w, h = im.size
    except Exception:
        h = w = 800
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)
    poses[:, :3, 3] *= config.scale_factor
    aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=_make_cameras(poses, focal, focal, w / 2.0, h / 2.0, h, w),
        scene_box_aabb=aabb, dataparser_scale=config.scale_factor,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


@dataclasses.dataclass
class InstantNGPDataparserConfig:
    """``instant_ngp_dataparser.py``: transforms.json with aabb_scale."""
    data: Path = Path("data/ours/posterv2")
    scene_scale: float = 0.33


def parse_instant_ngp_data(config: InstantNGPDataparserConfig,
                           split: str = "train") -> DataparserOutputs:
    data = Path(config.data)
    f = data / "transforms.json" if data.is_dir() else data
    meta = json.loads(f.read_text())
    data_dir = f.parent
    image_filenames, poses = [], []
    for frame in meta["frames"]:
        image_filenames.append(data_dir / frame["file_path"])
        poses.append(np.array(frame["transform_matrix"], np.float32))
    poses = np.stack(poses)
    # instant-ngp convention: flip y/z axes of the rotation
    poses[:, 0:3, 1:3] *= -1
    poses[:, :3, 3] *= config.scene_scale
    h = int(meta["h"])
    w = int(meta["w"])
    aabb_scale = float(meta.get("aabb_scale", 1.0))
    aabb = np.array([[-aabb_scale] * 3, [aabb_scale] * 3], np.float32) / 2.0
    fl_x, fl_y = instant_ngp_focal_lengths(meta)
    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=_make_cameras(poses, fl_x, fl_y, meta["cx"], meta["cy"], h, w),
        scene_box_aabb=aabb, dataparser_scale=config.scene_scale,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


def instant_ngp_focal_lengths(meta: dict):
    """(fl_x, fl_y) of an instant-ngp ``transforms.json``: ``fl_x`` /
    ``fl_y`` when given, else from the fields of view (``x_fov`` /
    ``y_fov`` in degrees, ``camera_angle_x`` / ``camera_angle_y`` in
    radians) over ``w`` / ``h``; fl_y defaults to fl_x.  The JAX parser
    reads only ``fl_x`` / ``fl_y``, which the routing sends elsewhere."""
    def focal(key, fov_deg, angle, side):
        if key in meta:
            return float(meta[key])
        if fov_deg in meta:
            return float(meta[side]) / (2.0 * np.tan(float(meta[fov_deg]) * np.pi / 360.0))
        if angle in meta:
            return float(meta[side]) / (2.0 * np.tan(float(meta[angle]) / 2.0))
        return None

    fl_x = focal("fl_x", "x_fov", "camera_angle_x", "w")
    fl_y = focal("fl_y", "y_fov", "camera_angle_y", "h")
    if fl_x is None and fl_y is None:
        raise KeyError("transforms.json gives no focal length (fl_x, x_fov or "
                       "camera_angle_x)")
    return (fl_y if fl_x is None else fl_x), (fl_x if fl_y is None else fl_y)


@dataclasses.dataclass
class DNeRFDataparserConfig:
    """``dnerf_dataparser.py``: blender format + per-frame ``time``."""
    data: Path = Path("data/dnerf/lego")
    scale_factor: float = 1.0


def parse_dnerf_data(config: DNeRFDataparserConfig,
                     split: str = "train"):
    data = Path(config.data)
    meta = json.loads((data / f"transforms_{split}.json").read_text())
    image_filenames, poses, times = [], [], []
    for frame in meta["frames"]:
        fname = frame["file_path"].replace("./", "")
        if not fname.endswith(".png"):
            fname = fname + ".png"
        image_filenames.append(data / fname)
        poses.append(np.array(frame["transform_matrix"], np.float32))
        times.append(float(frame.get("time", 0.0)))
    poses = np.stack(poses)
    try:
        from PIL import Image
        with Image.open(image_filenames[0]) as im:
            w, h = im.size
    except Exception:
        h = w = 800
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    poses[:, :3, 3] *= config.scale_factor
    aabb = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
    out = DataparserOutputs(
        image_filenames=image_filenames,
        cameras=_make_cameras(poses, focal, focal, w / 2.0, h / 2.0, h, w),
        scene_box_aabb=aabb, dataparser_scale=config.scale_factor,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])
    return out, np.asarray(times, np.float32)


@dataclasses.dataclass
class MinimalDataparserConfig:
    """``minimal_dataparser.py``: pre-computed npz with poses/intrinsics."""
    data: Path = Path("data/minimal")


def parse_minimal_data(config: MinimalDataparserConfig,
                       split: str = "train") -> DataparserOutputs:
    d = np.load(Path(config.data) / f"{split}.npz", allow_pickle=True)
    poses = d["poses"].astype(np.float32)
    fnames = [Path(p) for p in d["image_filenames"]]
    aabb = d.get("aabb", np.array([[-1, -1, -1], [1, 1, 1]], np.float32))
    return DataparserOutputs(
        image_filenames=fnames,
        cameras=_make_cameras(poses, d["fx"], d["fy"], d["cx"], d["cy"],
                              int(d["height"]), int(d["width"])),
        scene_box_aabb=np.asarray(aabb, np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


dataparser_registry = {
    "nerfstudio-data": parse_nerfstudio_data,
    "blender-data": parse_blender_data,
    "instant-ngp-data": parse_instant_ngp_data,
    "dnerf-data": parse_dnerf_data,
    "minimal-parser": parse_minimal_data,
}


@dataclasses.dataclass
class PhototourismDataparserConfig:
    """``phototourism_dataparser.py``: COLMAP reconstruction of internet
    photo collections (variable intrinsics per image)."""
    data: Path = Path("data/phototourism/brandenburg-gate")


def parse_phototourism_data(config: PhototourismDataparserConfig,
                            split: str = "train") -> DataparserOutputs:
    from samnerf_tpu_torch.preprocessing import colmap_utils as cu
    recon = Path(config.data) / "dense" / "sparse"
    if not recon.exists():
        recon = Path(config.data)
    if (recon / "cameras.bin").exists():
        cams = cu.read_cameras_binary(recon / "cameras.bin")
        images = cu.read_images_binary(recon / "images.bin")
    else:
        cams = cu.read_cameras_text(recon / "cameras.txt")
        images = cu.read_images_text(recon / "images.txt")
    fnames, poses, fxs, fys, cxs, cys = [], [], [], [], [], []
    h = w = None
    for iid in sorted(images):
        im = images[iid]
        rot = cu.qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL
        poses.append(c2w.astype(np.float32))
        cam = cams[im.camera_id]
        intr, _ = cu._intrinsics(cam)
        fxs.append(intr["fl_x"]); fys.append(intr["fl_y"])
        cxs.append(intr["cx"]); cys.append(intr["cy"])
        h, w = cam.height, cam.width
        fnames.append(Path(config.data) / "dense" / "images" / im.name)
    poses = np.stack(poses)
    cameras = _make_cameras(poses, fxs, fys, cxs, cys, h, w)
    return DataparserOutputs(
        image_filenames=fnames, cameras=cameras,
        scene_box_aabb=np.array([[-5, -5, -5], [5, 5, 5]], np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


@dataclasses.dataclass
class SDFStudioDataparserConfig:
    """``sdfstudio_dataparser.py``: meta_data.json with per-frame
    camtoworld + intrinsics."""
    data: Path = Path("data/sdfstudio")


def parse_sdfstudio_data(config: SDFStudioDataparserConfig,
                         split: str = "train") -> DataparserOutputs:
    meta = json.loads((Path(config.data) / "meta_data.json").read_text())
    fnames, poses = [], []
    fx = fy = cx = cy = None
    for frame in meta["frames"]:
        fnames.append(Path(config.data) / frame["rgb_path"])
        poses.append(np.array(frame["camtoworld"], np.float32))
        k = np.array(frame["intrinsics"])
        fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    poses = np.stack(poses)
    poses[:, 0:3, 1:3] *= -1  # OpenCV -> OpenGL
    h = int(meta["height"])
    w = int(meta["width"])
    aabb = np.array(meta.get(
        "scene_box", {}).get("aabb", [[-1, -1, -1], [1, 1, 1]]), np.float32)
    return DataparserOutputs(
        image_filenames=fnames,
        cameras=_make_cameras(poses, fx, fy, cx, cy, h, w),
        scene_box_aabb=aabb, dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


@dataclasses.dataclass
class ScanNetDataparserConfig:
    """``scannet_dataparser.py``: per-frame pose txt + intrinsic txt."""
    data: Path = Path("data/scannet/scene0423_02")


def parse_scannet_data(config: ScanNetDataparserConfig,
                       split: str = "train") -> DataparserOutputs:
    d = Path(config.data)
    k = np.loadtxt(d / "intrinsic" / "intrinsic_color.txt")
    pose_files = sorted((d / "pose").glob("*.txt"),
                        key=lambda p: int(p.stem))
    fnames, poses = [], []
    for pf in pose_files:
        m = np.loadtxt(pf).astype(np.float32)
        if not np.isfinite(m).all():
            continue
        m[0:3, 1:3] *= -1  # OpenCV -> OpenGL
        poses.append(m)
        fnames.append(d / "color" / f"{pf.stem}.jpg")
    poses = np.stack(poses)
    # probe image size from first color image; scannet color is 1296x968
    try:
        from PIL import Image
        with Image.open(fnames[0]) as im:
            w, h = im.size
    except Exception:
        w, h = 1296, 968
    return DataparserOutputs(
        image_filenames=fnames,
        cameras=_make_cameras(poses, k[0, 0], k[1, 1], k[0, 2], k[1, 2],
                              h, w),
        scene_box_aabb=np.array([[-5, -5, -5], [5, 5, 5]], np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


@dataclasses.dataclass
class ARKitScenesDataparserConfig:
    """``arkitscenes_dataparser.py``: lowres_wide traj file + pincam
    intrinsics."""
    data: Path = Path("data/arkitscenes/41069021")


def parse_arkitscenes_data(config: ARKitScenesDataparserConfig,
                           split: str = "train") -> DataparserOutputs:
    d = Path(config.data)
    traj = (d / "lowres_wide.traj").read_text().splitlines()
    fnames, poses, fxs, fys, cxs, cys = [], [], [], [], [], []
    h = w = None
    for line in traj:
        p = line.split()
        if len(p) < 7:
            continue
        ts = p[0]
        # axis-angle rotation + translation (ARKit traj format)
        rv = np.array([float(x) for x in p[1:4]])
        t = np.array([float(x) for x in p[4:7]])
        theta = np.linalg.norm(rv)
        if theta > 1e-12:
            kx, ky, kz = rv / theta
            kmat = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
            rot = (np.eye(3) + np.sin(theta) * kmat
                   + (1 - np.cos(theta)) * kmat @ kmat)
        else:
            rot = np.eye(3)
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = t
        c2w = np.linalg.inv(w2c).astype(np.float32)
        c2w[0:3, 1:3] *= -1
        # matching pincam: <ts>.pincam "w h fx fy cx cy"
        stem = f"{float(ts):.3f}"
        pincam = d / "lowres_wide_intrinsics" / f"{stem}.pincam"
        if not pincam.exists():
            continue
        vals = [float(x) for x in pincam.read_text().split()]
        w, h = int(vals[0]), int(vals[1])
        fxs.append(vals[2]); fys.append(vals[3])
        cxs.append(vals[4]); cys.append(vals[5])
        poses.append(c2w)
        fnames.append(d / "lowres_wide" / f"{stem}.png")
    poses = np.stack(poses)
    cameras = _make_cameras(poses, fxs, fys, cxs, cys, h, w)
    return DataparserOutputs(
        image_filenames=fnames, cameras=cameras,
        scene_box_aabb=np.array([[-3, -3, -3], [3, 3, 3]], np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


@dataclasses.dataclass
class DycheckDataparserConfig:
    """``dycheck_dataparser.py``: iPhone dataset (dataset.json +
    per-frame camera json + metadata times)."""
    data: Path = Path("data/iphone/mochi-high-five")
    downscale_factor: int = 1


def parse_dycheck_data(config: DycheckDataparserConfig, split: str = "train"):
    d = Path(config.data)
    ds = json.loads((d / "dataset.json").read_text())
    names = ds.get(split + "_ids", ds.get("ids", []))
    meta = json.loads((d / "metadata.json").read_text()) \
        if (d / "metadata.json").exists() else {}
    fnames, poses, times = [], [], []
    fx = fy = cx = cy = None
    h = w = None
    for name in names:
        cam = json.loads((d / "camera" / f"{name}.json").read_text())
        rot = np.array(cam["orientation"]).T   # dycheck stores w2c rows
        pos = np.array(cam["position"])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = rot
        c2w[:3, 3] = pos
        c2w[0:3, 1:3] *= -1
        poses.append(c2w)
        fx = fy = float(cam["focal_length"])
        cx, cy = [float(x) for x in cam["principal_point"]]
        h, w = [int(x) for x in cam["image_size"][::-1]]
        fnames.append(d / "rgb" / f"{config.downscale_factor}x"
                      / f"{name}.png")
        times.append(float(meta.get(name, {}).get("time_id", 0.0)))
    poses = np.stack(poses)
    tmax = max(max(times), 1.0)
    out = DataparserOutputs(
        image_filenames=fnames,
        cameras=_make_cameras(poses, fx, fy, cx, cy, h, w),
        scene_box_aabb=np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]],
                                np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])
    return out, np.asarray(times, np.float32) / tmax


@dataclasses.dataclass
class Sitcoms3DDataparserConfig:
    """``sitcoms3d_dataparser.py``: cameras.json with K + c2w per frame."""
    data: Path = Path("data/sitcoms3d/TBBT-big_living_room")


def parse_sitcoms3d_data(config: Sitcoms3DDataparserConfig,
                         split: str = "train") -> DataparserOutputs:
    d = Path(config.data)
    meta = json.loads((d / "cameras.json").read_text())
    frames = meta["frames"]
    fnames, poses, fxs, fys, cxs, cys = [], [], [], [], [], []
    h = w = None
    for fr in frames:
        k = np.array(fr["intrinsics"])
        c2w = np.array(fr["camtoworld"], np.float32)
        c2w[0:3, 1:3] *= -1
        poses.append(c2w)
        fxs.append(k[0, 0]); fys.append(k[1, 1])
        cxs.append(k[0, 2]); cys.append(k[1, 2])
        fnames.append(d / "images" / fr["image_name"])
        h, w = int(k[1, 2] * 2), int(k[0, 2] * 2)
    poses = np.stack(poses)
    cameras = _make_cameras(poses, fxs, fys, cxs, cys, h, w)
    return DataparserOutputs(
        image_filenames=fnames, cameras=cameras,
        scene_box_aabb=np.asarray(meta.get("aabb", [[-1, -1, -1],
                                                    [1, 1, 1]]), np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3])


dataparser_registry.update({
    "phototourism-data": parse_phototourism_data,
    "sdfstudio-data": parse_sdfstudio_data,
    "scannet-data": parse_scannet_data,
    "arkitscenes-data": parse_arkitscenes_data,
    "dycheck-data": parse_dycheck_data,
    "sitcoms3d-data": parse_sitcoms3d_data,
})


# --- NuScenes ------------------------------------------------------------------


def _quat_to_rot(q) -> np.ndarray:
    """Scalar-first (w, x, y, z) quaternion -> 3x3 rotation matrix (the
    convention the NuScenes devkit's pyquaternion uses,
    ``nuscenes_dataparser.py:37-49``); normalizing helper shared with
    the converters."""
    from samnerf_tpu_torch.preprocessing.converters import _quat_to_rot as qr
    return qr(*(float(v) for v in q))


def _nusc_pose(rotation, translation) -> np.ndarray:
    pose = np.eye(4)
    pose[:3, :3] = _quat_to_rot(rotation)
    pose[:3, 3] = translation
    return pose


@dataclasses.dataclass
class NuScenesDataparserConfig:
    """``nuscenes_dataparser.py:53-80``.  ``data`` is the scene name
    (e.g. "scene-0103"); ``data_dir`` the dataset root.  Instead of the
    nuscenes devkit (absent here) the relational table JSONs under
    ``<data_dir>/<version>/`` are read directly — the devkit is only a
    loader for those same files."""
    data: str = "scene-0103"
    data_dir: Path = Path("/mnt/local/NuScenes")
    version: str = "v1.0-mini"
    cameras: tuple = ("FRONT",)
    mask_dir: Optional[Path] = None
    train_split_fraction: float = 0.9


def parse_nuscenes_data(config: NuScenesDataparserConfig,
                        split: str = "train") -> DataparserOutputs:
    """``nuscenes_dataparser.py:85-218``: ego@cam poses, opencv->nerfstudio
    axis shuffles, pose centering + max-abs scaling, equally-spaced train
    split, fixed unit scene box."""
    import math

    root = Path(config.data_dir)
    tdir = root / config.version

    def table(name):
        return {r["token"]: r
                for r in json.loads((tdir / f"{name}.json").read_text())}

    scenes = json.loads((tdir / "scene.json").read_text())
    sample_t = table("sample")
    sample_data = json.loads((tdir / "sample_data.json").read_text())
    calib_t = table("calibrated_sensor")
    ego_t = table("ego_pose")
    sensor_t = table("sensor")

    scene = next(s for s in scenes if s["name"] == str(config.data))
    samples = [s for s in sample_t.values()
               if s["scene_token"] == scene["token"]]
    samples.sort(key=lambda s: (s["scene_token"], s["timestamp"]))
    cam_names = ["CAM_" + c for c in config.cameras]
    assert len(cam_names) == 1, "waiting on multiple camera support"

    # key-frame sample_data rows per (sample, channel)
    by_sample = {}
    for sd in sample_data:
        if not sd["is_key_frame"]:
            continue
        calib = calib_t[sd["calibrated_sensor_token"]]
        channel = sensor_t[calib["sensor_token"]]["channel"]
        if channel in cam_names:
            by_sample[(sd["sample_token"], channel)] = sd

    transform1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                           [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    transform2 = np.array([[0, 0, 1, 0], [0, 1, 0, 0],
                           [-1, 0, 0, 0], [0, 0, 0, 1]], np.float64)

    image_filenames, mask_filenames, intrinsics, poses = [], [], [], []
    for sample in samples:
        for channel in cam_names:
            sd = by_sample[(sample["token"], channel)]
            calib = calib_t[sd["calibrated_sensor_token"]]
            ego = ego_t[sd["ego_pose_token"]]
            pose = (_nusc_pose(ego["rotation"], ego["translation"])
                    @ _nusc_pose(calib["rotation"], calib["translation"]))
            pose = transform1 @ pose
            pose[0:3, 1:3] *= -1
            pose = pose[np.array([1, 0, 2, 3]), :]
            pose[2, :] *= -1
            pose = transform2 @ pose
            image_filenames.append(root / sd["filename"])
            if config.mask_dir is not None:
                name = Path(sd["filename"]).name.replace("jpg", "png")
                mask_filenames.append(
                    Path(config.mask_dir) / "masks" / channel / name)
            intrinsics.append(np.asarray(calib["camera_intrinsic"],
                                         np.float32))
            poses.append(pose)

    poses = np.stack(poses).astype(np.float32)
    intrinsics = np.stack(intrinsics)
    poses[:, :3, 3] -= poses[:, :3, 3].mean(axis=0)
    poses[:, :3, 3] /= np.abs(poses[:, :3, 3]).max()

    num = len(samples)
    n_train = math.ceil(num * config.train_split_fraction)
    i_train = np.linspace(0, num - 1, n_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(num), i_train)
    indices = i_train if split == "train" else i_eval

    cameras = _make_cameras(poses[indices], intrinsics[indices, 0, 0],
                            intrinsics[indices, 1, 1], intrinsics[indices, 0, 2],
                            intrinsics[indices, 1, 2], 900, 1600)
    return DataparserOutputs(
        image_filenames=[image_filenames[i] for i in indices],
        cameras=cameras,
        scene_box_aabb=np.asarray([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],
                                  np.float32),
        dataparser_scale=1.0,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3],
        mask_filenames=([mask_filenames[i] for i in indices]
                        if config.mask_dir is not None else None))


dataparser_registry["nuscenes-data"] = parse_nuscenes_data
