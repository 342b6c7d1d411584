"""Pose converters: Polycam, Record3D, Agisoft Metashape and
RealityCapture captures -> nerfstudio's ``transforms.json``, and an hloc
structure-from-motion wrapper.

The port's copy of ``samnerf_tpu/preprocessing/converters.py`` (host
numpy; COLMAP models are read by
:mod:`samnerf_tpu_torch.preprocessing.colmap_utils`).  hloc is an external
toolbox: :func:`hloc_plan` builds its run's paths and configuration
names, and :func:`run_hloc` raises an ``ImportError`` when it is absent.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np


def polycam_to_json(keyframe_dir: Path, output_dir: Path,
                    min_blur_score: float = 25.0) -> int:
    """Polycam keyframes (cameras/*.json + images) -> transforms.json
    (``polycam_utils.py`` polycam_to_json)."""
    keyframe_dir = Path(keyframe_dir)
    cam_dir = keyframe_dir / "cameras"
    frames: List[dict] = []
    for cam_file in sorted(cam_dir.glob("*.json")):
        c = json.loads(cam_file.read_text())
        if c.get("blur_score", 1e9) < min_blur_score:
            continue
        # polycam stores a row-major 4x4 via t_00..t_23 keys (ARKit frame)
        m = np.array([
            [c["t_00"], c["t_01"], c["t_02"], c["t_03"]],
            [c["t_10"], c["t_11"], c["t_12"], c["t_13"]],
            [c["t_20"], c["t_21"], c["t_22"], c["t_23"]],
            [0.0, 0.0, 0.0, 1.0]])
        # ARKit -> nerfstudio: swap to y-up, -z forward
        m = m[np.array([1, 0, 2, 3]), :]
        m[2, :] *= -1
        frames.append({
            "file_path": f"images/{cam_file.stem}.jpg",
            "fl_x": c["fx"], "fl_y": c["fy"], "cx": c["cx"], "cy": c["cy"],
            "w": c["width"], "h": c["height"],
            "transform_matrix": m.tolist(),
        })
    out = {"camera_model": "OPENCV", "frames": frames}
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    return len(frames)


def record3d_to_json(metadata_path: Path, output_dir: Path,
                     image_dir_name: str = "rgb") -> int:
    """Record3D ``metadata.json`` (quaternion poses + K) -> transforms.json
    (``record3d_utils.py`` record3d_to_json)."""
    meta = json.loads(Path(metadata_path).read_text())
    k = np.array(meta["K"]).reshape(3, 3).T
    poses = np.array(meta["poses"])  # [N, 7]: qx qy qz qw tx ty tz
    frames = []
    for i, p in enumerate(poses):
        qx, qy, qz, qw, tx, ty, tz = p
        r = _quat_to_rot(qw, qx, qy, qz)
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = [tx, ty, tz]
        frames.append({
            "file_path": f"{image_dir_name}/{i}.jpg",
            "transform_matrix": m.tolist(),
        })
    out = {
        "fl_x": float(k[0, 0]), "fl_y": float(k[1, 1]),
        "cx": float(k[0, 2]), "cy": float(k[1, 2]),
        "w": int(meta.get("w", k[0, 2] * 2)),
        "h": int(meta.get("h", k[1, 2] * 2)),
        "camera_model": "OPENCV",
        "frames": frames,
    }
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    return len(frames)


def _quat_to_rot(w, x, y, z) -> np.ndarray:
    """Scalar-first unit quaternion -> 3x3 rotation (normalizes first;
    shared by the polycam/record3d converters and the NuScenes parser)."""
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def metashape_to_json(image_filename_map, xml_filename: Path,
                      output_dir: Path) -> List[str]:
    """Agisoft Metashape cameras.xml -> transforms.json
    (``metashape_utils.py:37-143``).

    image_filename_map: {camera label (no extension): saved image Path}.
    One calibrated sensor supported; intrinsics are f/cx/cy offsets from
    the image center plus k1-k4/p1-p2; each camera ``transform`` is
    row-major camera-to-chunk, re-axed into nerfstudio's convention by
    the (z, x, y) row shuffle with y/z negation.
    """
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_filename).getroot()
    chunk = root[0]
    sensors = chunk.find("sensors")
    if sensors is None:
        raise ValueError("No sensors found")
    calibrated = [s for s in sensors if s.find("calibration") is not None]
    if len(calibrated) != 1:
        raise ValueError("Only one calibrated sensor is supported")
    sensor = calibrated[0]
    res = sensor.find("resolution")
    calib = sensor.find("calibration")

    def dist(name):
        el = calib.find(name)
        return float(el.text) if el is not None else 0.0

    w = int(res.get("width"))
    h = int(res.get("height"))
    data = {
        "w": w, "h": h,
        "fl_x": float(calib.find("f").text),
        "fl_y": float(calib.find("f").text),
        "cx": dist("cx") + w / 2.0,
        "cy": dist("cy") + h / 2.0,
        "k1": dist("k1"), "k2": dist("k2"), "k3": dist("k3"),
        "k4": dist("k4"), "p1": dist("p1"), "p2": dist("p2"),
        "camera_model": "OPENCV",
    }
    frames = []
    skipped = 0
    for camera in chunk.find("cameras"):
        label = camera.get("label").split(".")[0]
        if label not in image_filename_map:
            continue
        if camera.get("sensor_id") != sensor.get("id") or \
                camera.find("transform") is None:
            skipped += 1
            continue
        t = [float(x) for x in camera.find("transform").text.split()]
        transform = np.array([
            [t[8], -t[9], -t[10], t[11]],
            [t[0], -t[1], -t[2], t[3]],
            [t[4], -t[5], -t[6], t[7]],
            [t[12], -t[13], -t[14], t[15]],
        ])
        frames.append({
            "file_path": Path(image_filename_map[label]).as_posix(),
            "transform_matrix": transform.tolist(),
        })
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(
        json.dumps(data, indent=4))
    summary = []
    if skipped:
        summary.append(f"{skipped} images skipped (missing pose/calib).")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


def _euler_to_rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """RealityCapture heading/pitch/roll (degrees) -> rotation
    (``realitycapture_utils.py:123-135``: Rz(yaw) @ Rx(pitch) @ Ry(roll))."""
    sy, cy = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
    sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
    sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
    rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rot_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    rot_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rot_z @ rot_x @ rot_y


def realitycapture_to_json(image_filename_map, csv_filename: Path,
                           output_dir: Path,
                           image_size=None) -> List[str]:
    """RealityCapture pose CSV -> transforms.json
    (``realitycapture_utils.py:31-118``).

    image_filename_map: {image basename (no ext): saved image Path}.
    Focal lengths are 35mm-equivalent (f * max(w, h) / 36); principal
    point offsets px/py likewise; heading is negated into yaw.
    image_size: optional (h, w) override, else read from the first image.
    """
    import csv as _csv

    with open(csv_filename, encoding="UTF-8") as f:
        rows = list(_csv.DictReader(f))

    if image_size is None:
        from PIL import Image
        first = next(r for r in rows
                     if r["#name"].split(".")[0] in image_filename_map)
        p = Path(output_dir) / image_filename_map[
            first["#name"].split(".")[0]]
        with Image.open(p) as im:
            w, h = im.size
    else:
        h, w = image_size

    data = {"camera_model": "OPENCV", "orientation_override": "none",
            "h": int(h), "w": int(w)}
    frames = []
    missing = 0
    for r in rows:
        base = r["#name"].split(".")[0]
        if base not in image_filename_map:
            missing += 1
            continue
        transform = np.eye(4)
        transform[:3, :3] = _euler_to_rot(-float(r["heading"]),
                                          float(r["pitch"]),
                                          float(r["roll"]))
        transform[:3, 3] = [float(r["x"]), float(r["y"]), float(r["alt"])]
        frames.append({
            "file_path": Path(image_filename_map[base]).as_posix(),
            "fl_x": float(r["f"]) * max(w, h) / 36.0,
            "fl_y": float(r["f"]) * max(w, h) / 36.0,
            "cx": float(r["px"]) / 36.0 + w / 2.0,
            "cy": float(r["py"]) / 36.0 + h / 2.0,
            "k1": r["k1"], "k2": r["k2"], "k3": r["k3"], "k4": r["k4"],
            "p1": r["t1"], "p2": r["t2"],
            "transform_matrix": transform.tolist(),
        })
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(
        json.dumps(data, indent=4))
    summary = []
    if missing:
        summary.append(f"Missing image data for {missing} cameras.")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


def hloc_plan(image_dir: Path, colmap_dir: Path,
              feature_type: str = "superpoint_aachen",
              matcher_type: str = "superglue", num_matched: int = 50) -> dict:
    """The paths and configuration names of an hloc run (retrieval with
    netvlad, features, matches, COLMAP reconstruction into
    ``<colmap_dir>/sparse/0``); ``num_matched`` is capped at the number of
    images."""
    outputs = Path(colmap_dir)
    num_images = len(list(Path(image_dir).iterdir())) if Path(image_dir).is_dir() else 0
    return {"image_dir": Path(image_dir), "outputs": outputs,
            "sfm_pairs": outputs / "pairs-netvlad.txt",
            "sfm_dir": outputs / "sparse" / "0",
            "retrieval_conf": "netvlad", "feature_conf": feature_type,
            "matcher_conf": matcher_type,
            "num_matched": min(num_matched, num_images)}


def run_hloc(image_dir: Path, colmap_dir: Path,
             feature_type: str = "superpoint_aachen",
             matcher_type: str = "superglue",
             num_matched: int = 50) -> None:
    """Structure from motion with the hloc toolbox over :func:`hloc_plan`;
    its COLMAP model feeds :func:`samnerf_tpu_torch.preprocessing
    .colmap_utils.colmap_to_json`.  Raises ``ImportError`` when hloc is
    not installed."""
    try:
        from hloc import (extract_features, match_features,  # noqa: F401
                          pairs_from_retrieval, reconstruction)
    except ImportError as e:
        raise ImportError(
            "run_hloc needs the hloc toolbox "
            "(https://github.com/cvg/Hierarchical-Localization), which is not "
            "installed") from e
    plan = hloc_plan(image_dir, colmap_dir, feature_type, matcher_type, num_matched)
    plan["outputs"].mkdir(parents=True, exist_ok=True)
    feature_conf = extract_features.confs[plan["feature_conf"]]
    retrieval_path = extract_features.main(
        extract_features.confs[plan["retrieval_conf"]], plan["image_dir"], plan["outputs"])
    pairs_from_retrieval.main(retrieval_path, plan["sfm_pairs"],
                              num_matched=plan["num_matched"])
    feature_path = extract_features.main(feature_conf, plan["image_dir"], plan["outputs"])
    match_path = match_features.main(match_features.confs[plan["matcher_conf"]],
                                     plan["sfm_pairs"], feature_conf["output"],
                                     plan["outputs"])
    reconstruction.main(plan["sfm_dir"], plan["image_dir"], plan["sfm_pairs"],
                        feature_path, match_path)
