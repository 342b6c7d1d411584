"""Process-data helpers: list, subsample, copy and downscale images,
fisheye and crop masks, and video frames through ffmpeg.

The port's copy of ``samnerf_tpu/preprocessing/process_data_utils.py``
(host numpy and PIL).  Video extraction calls the ffmpeg / ffprobe
binaries: their argument lists are built by
:func:`ffmpeg_extract_command` and :func:`ffprobe_frame_count_command`,
and :func:`convert_video_to_images` raises a ``RuntimeError`` when ffmpeg
is not installed.
"""
from __future__ import annotations

import shutil
import subprocess
from collections import OrderedDict
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

CAMERA_MODELS = {
    "perspective": "OPENCV",
    "fisheye": "OPENCV_FISHEYE",
    "equirectangular": "EQUIRECTANGULAR",
}

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def list_images(data: Path) -> List[Path]:
    """Sorted image paths under ``data`` (``process_data_utils.py:50-60``)."""
    return sorted(p for p in Path(data).iterdir()
                  if p.suffix.lower() in IMAGE_SUFFIXES)


def get_image_filenames(directory: Path, max_num_images: int = -1
                        ) -> Tuple[List[Path], int]:
    """Evenly-spaced subset of the images (``:63-82``)."""
    files = list_images(directory)
    num_orig = len(files)
    if max_num_images != -1 and num_orig > max_num_images:
        idx = np.round(np.linspace(0, num_orig - 1,
                                   max_num_images)).astype(int)
        files = [files[i] for i in idx]
    return files, num_orig


def copy_images_list(image_paths: List[Path], image_dir: Path,
                     crop_border_pixels: Optional[int] = None
                     ) -> List[Path]:
    """Copy/renumber images to ``frame_%05d``; optional border crop
    (``:171-213``)."""
    from PIL import Image
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for i, src in enumerate(image_paths):
        dst = image_dir / f"frame_{i + 1:05d}{src.suffix.lower()}"
        if crop_border_pixels:
            with Image.open(src) as im:
                w, h = im.size
                c = crop_border_pixels
                im.crop((c, c, w - c, h - c)).save(dst)
        else:
            shutil.copy(src, dst)
        out.append(dst)
    return out


def copy_images(data: Path, image_dir: Path,
                max_num_images: int = -1) -> "OrderedDict[Path, Path]":
    """Copy a directory of images; returns {original: new} (``:264-282``)."""
    files, _ = get_image_filenames(data, max_num_images)
    copied = copy_images_list(files, image_dir)
    return OrderedDict(zip(files, copied))


def downscale_images(image_dir: Path, num_downscales: int) -> str:
    """Write images_2/, images_4/, ... next to ``image_dir`` at halved
    resolutions (``:285-335``; PIL instead of ffmpeg scale filters)."""
    from PIL import Image
    image_dir = Path(image_dir)
    files = list_images(image_dir)
    for i in range(num_downscales):
        factor = 2 ** (i + 1)
        out_dir = image_dir.parent / f"{image_dir.name}_{factor}"
        out_dir.mkdir(exist_ok=True)
        for src in files:
            with Image.open(src) as im:
                w, h = im.size
                im.resize((max(1, w // factor), max(1, h // factor)),
                          Image.BILINEAR).save(out_dir / src.name)
    scales = ", ".join(f"{2 ** (i + 1)}x" for i in range(num_downscales))
    return f"We downsampled the images by {scales}"


def ffprobe_frame_count_command(video: Path) -> List[str]:
    """The ffprobe call that counts a video's frames."""
    return ["ffprobe", "-v", "error", "-select_streams", "v:0",
            "-count_packets", "-show_entries", "stream=nb_read_packets",
            "-of", "csv=p=0", str(video)]


def get_num_frames_in_video(video: Path) -> int:
    """ffprobe's frame count; -1 when ffprobe is missing."""
    if shutil.which("ffprobe") is None:
        return -1
    out = subprocess.run(ffprobe_frame_count_command(video), capture_output=True,
                         text=True, check=False).stdout.strip()
    return int(out) if out.isdigit() else -1


def ffmpeg_extract_command(video_path: Path, image_dir: Path, num_frames: int,
                           num_frames_target: int,
                           crop_factor=(0.0, 0.0, 0.0, 0.0)) -> List[str]:
    """The ffmpeg call that writes every ``num_frames // num_frames_target``-th
    frame (a thumbnail filter) as ``frame_%05d.png``, cropped by the (top,
    bottom, left, right) fractions."""
    spacing = max(num_frames // max(num_frames_target, 1), 1)
    vf = [f"thumbnail={spacing},setpts=N/TB"]
    top, bottom, left, right = crop_factor
    if any(crop_factor):
        h = f"ih*(1-{top}-{bottom})"
        w = f"iw*(1-{left}-{right})"
        vf.append(f"crop=w={w}:h={h}:x=iw*{left}:y=ih*{top}")
    return ["ffmpeg", "-i", str(video_path), "-vf", ",".join(vf), "-r", "1",
            str(Path(image_dir) / "frame_%05d.png")]


def convert_video_to_images(video_path: Path, image_dir: Path,
                            num_frames_target: int,
                            crop_factor=(0.0, 0.0, 0.0, 0.0)
                            ) -> Tuple[List[str], int]:
    """Extract evenly spaced frames with ffmpeg
    (:func:`ffmpeg_extract_command`); raises ``RuntimeError`` when no
    ffmpeg binary is on the path."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "convert_video_to_images needs an ffmpeg binary on the PATH; none "
            "was found. Extract the frames elsewhere and use copy_images on them.")
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    cmd = ffmpeg_extract_command(video_path, image_dir, get_num_frames_in_video(video_path),
                                 num_frames_target, crop_factor)
    subprocess.run(cmd, check=True, capture_output=True)
    n = len(list_images(image_dir))
    return [f"Extracted {n} frames from {Path(video_path).name}"], n


def generate_circle_mask(height: int, width: int,
                         percent_radius: float) -> Optional[np.ndarray]:
    """Fisheye circle mask (``:391-411``); None when it would be all-true."""
    if percent_radius <= 0.0:
        raise ValueError("percent_radius must be positive")
    if percent_radius >= np.sqrt(2.0):
        return None
    mask = np.zeros((height, width), dtype=np.uint8)
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    cy, cx = height / 2.0, width / 2.0
    r = percent_radius * min(height, width) / 2.0
    mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2] = 1
    return mask.astype(bool)


def generate_crop_mask(height: int, width: int,
                       crop_factor=(0.0, 0.0, 0.0, 0.0)
                       ) -> Optional[np.ndarray]:
    """Border crop mask (``:414-439``)."""
    if all(c == 0.0 for c in crop_factor):
        return None
    if any(c < 0.0 or c > 1.0 for c in crop_factor):
        raise ValueError("crop fractions must be in [0, 1]")
    top, bottom, left, right = crop_factor
    mask = np.zeros((height, width), dtype=bool)
    mask[int(height * top): height - int(height * bottom),
         int(width * left): width - int(width * right)] = True
    return mask
