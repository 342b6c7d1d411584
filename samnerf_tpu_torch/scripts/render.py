"""Render a camera path from a run directory's latest checkpoint into PNG
frames, and optionally a video.

Counterpart of ``samnerf_tpu/scripts/render.py``::

    python -m samnerf_tpu_torch.scripts.render RUN_DIR --output frames/ \\
        [--traj orbit|spiral|interpolate|filename] [--num-frames 60] \\
        [--width 512 --height 512] [--orbit-radius 1.5] [--fov-deg 60] \\
        [--camera-path-filename camera_path.json] [--video out.gif]

``orbit`` circles the origin at ``--orbit-radius``; ``spiral`` winds
around the first training camera; ``interpolate`` slerps through the
eval cameras; ``filename`` renders a camera path the viewer saved.  The
video needs ``imageio``; frames stay when it fails.  Runs on the card;
exits 1 when there is none.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def orbit_c2w(theta: float, radius: float, height: float = 0.3,
              target=np.zeros(3)) -> np.ndarray:
    """[3, 4] camera at angle ``theta`` on a circle of ``radius`` at
    ``height``, looking at ``target`` with z up."""
    position = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    forward = target - position
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)[:3]
    c2w[:, 0] = right
    c2w[:, 1] = true_up
    c2w[:, 2] = -forward
    c2w[:, 3] = position
    return c2w


def path_cameras(args, trainer):
    """The trajectory's host ``Cameras``."""
    from samnerf_tpu_torch.core import camera_paths as cp
    from samnerf_tpu_torch.core.cameras import Cameras

    if args.traj == "filename":
        return cp.get_path_from_json(json.loads(Path(args.camera_path_filename).read_text()))
    if args.traj == "interpolate":
        cams = trainer.datamanager.eval_cameras
        n = cams.camera_to_worlds.shape[0]
        return cp.get_interpolated_camera_path(cams, max(args.num_frames // max(n - 1, 1), 1))
    if args.traj == "spiral":
        return cp.get_spiral_path(trainer.datamanager.cameras, steps=args.num_frames,
                                  radius=0.1)
    c2ws = np.stack([orbit_c2w(2 * np.pi * i / args.num_frames, args.orbit_radius)
                     for i in range(args.num_frames)]).astype(np.float32)
    n = c2ws.shape[0]
    focal = 0.5 * args.width / np.tan(np.deg2rad(args.fov_deg) / 2)

    def full(v):
        return torch.full((n, 1), float(v))

    return Cameras(camera_to_worlds=torch.as_tensor(c2ws), fx=full(focal), fy=full(focal),
                   cx=full(args.width / 2.0), cy=full(args.height / 2.0),
                   width=args.width, height=args.height)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--output", default="renders")
    ap.add_argument("--num-frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--orbit-radius", type=float, default=1.5)
    ap.add_argument("--fov-deg", type=float, default=60.0)
    ap.add_argument("--traj", default="orbit",
                    choices=("orbit", "spiral", "interpolate", "filename"))
    ap.add_argument("--camera-path-filename", default="camera_path.json",
                    help="a camera path the viewer saved (with --traj filename)")
    ap.add_argument("--video", default=None,
                    help="also write the frames as this video or gif (needs imageio)")
    args = ap.parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.render: no CUDA device", file=sys.stderr)
        return 1

    from PIL import Image

    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.utils.eval_utils import eval_setup

    trainer, _ = eval_setup(Path(args.run_dir), device=device)
    renderer = ImageRenderer(trainer.model)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    cams = path_cameras(args, trainer).to(trainer.device)
    num = cams.camera_to_worlds.shape[0]
    for i in range(num):
        rgb = renderer.render_image_device(cams, i, cams.width, cams.height,
                                           minimal=True)["rgb"]
        img = (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img).save(out_dir / f"frame_{i:05d}.png")
        print(f"frame {i + 1}/{num}", end="\r")
    print(f"\nwrote {num} frames to {out_dir}")
    if args.video:
        try:
            import imageio
            imageio.mimsave(args.video, [imageio.imread(out_dir / f"frame_{i:05d}.png")
                                         for i in range(num)], fps=24)
            print(f"wrote {args.video}")
        except Exception as e:   # no imageio, or no ffmpeg backend for mp4
            print(f"video assembly failed ({e}); frames are in {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
