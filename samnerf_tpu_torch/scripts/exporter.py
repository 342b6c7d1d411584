"""Geometry export from a trained run: a point cloud, a TSDF mesh or a
Poisson mesh.

Counterpart of ``samnerf_tpu/scripts/exporter.py``, same arguments and
defaults::

    python -m samnerf_tpu_torch.scripts.exporter pointcloud RUN_DIR --output cloud.ply
    python -m samnerf_tpu_torch.scripts.exporter tsdf RUN_DIR --output mesh.obj
    python -m samnerf_tpu_torch.scripts.exporter poisson RUN_DIR --output mesh.obj

It renders ``--num-views`` (8) orbit views of ``--width`` x ``--height``
(256 x 256) through the run's model, then back-projects their depth
(points with colours, or oriented points for Poisson at
``--resolution``) or fuses it into a ``--resolution``^3 (128) TSDF over
the box of half-side ``--aabb-scale`` (1.5).  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["pointcloud", "tsdf", "poisson"])
    ap.add_argument("run_dir")
    ap.add_argument("--output", required=True)
    ap.add_argument("--num-views", type=int, default=8)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=128,
                    help="TSDF voxel grid resolution")
    ap.add_argument("--aabb-scale", type=float, default=1.5)
    args = ap.parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.exporter: no CUDA device", file=sys.stderr)
        return 1

    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.exporter import exporter as ex
    from samnerf_tpu_torch.scripts.render import orbit_c2w
    from samnerf_tpu_torch.utils.eval_utils import eval_setup

    trainer, _ = eval_setup(Path(args.run_dir), device=device)
    dev = trainer.device
    renderer = ImageRenderer(trainer.model)
    focal = 0.5 * args.width / np.tan(np.deg2rad(30.0))
    aabb = np.array([[-args.aabb_scale] * 3, [args.aabb_scale] * 3], np.float32)

    def scalar(v):
        return torch.tensor([[v]], dtype=torch.float32, device=dev)

    views = []
    for i in range(args.num_views):
        c2w = orbit_c2w(2 * np.pi * i / args.num_views, args.aabb_scale)
        cams = Cameras(camera_to_worlds=torch.as_tensor(c2w[None], dtype=torch.float32,
                                                        device=dev),
                       fx=scalar(focal), fy=scalar(focal), cx=scalar(args.width / 2.0),
                       cy=scalar(args.height / 2.0),
                       width=args.width, height=args.height)
        out = renderer.render_image(cams, 0, width=args.width, height=args.height)
        intrin = np.array([[focal, 0, args.width / 2], [0, focal, args.height / 2],
                           [0, 0, 1]])
        views.append((out, intrin, c2w))
        print(f"rendered view {i + 1}/{args.num_views}", end="\r")
    print()

    if args.mode == "pointcloud":
        pts, cols = [], []
        for out, intrin, c2w in views:
            p, c = ex.backproject_depth(out["depth"], out["rgb"], out["accumulation"],
                                        intrin, c2w, min_accumulation=0.5)
            pts.append(p)
            cols.append(c)
        pts = np.concatenate(pts)
        ex.export_ply(Path(args.output), pts, colors=np.concatenate(cols))
        print(f"wrote {len(pts)} points to {args.output}")
    elif args.mode == "poisson":
        pts, nrms = [], []
        for out, intrin, c2w in views:
            p, n = ex.depth_to_oriented_points(out["depth"], out["accumulation"], intrin,
                                               c2w, min_accumulation=0.5)
            pts.append(p)
            nrms.append(n)
        pts = np.concatenate(pts)
        ex.export_poisson(Path(args.output), pts, np.concatenate(nrms), aabb,
                          resolution=args.resolution, device=dev)
        print(f"wrote poisson mesh from {len(pts)} oriented points to {args.output}")
    else:
        state = ex.tsdf_init(args.resolution, device=dev)
        for out, intrin, c2w in views:
            state = ex.tsdf_integrate(
                state, torch.as_tensor(out["depth"][..., 0], device=dev),
                torch.as_tensor(out["rgb"], device=dev),
                torch.as_tensor(intrin, dtype=torch.float32, device=dev),
                torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                torch.as_tensor(aabb, device=dev))
        tsdf, weight, _ = state
        verts, faces = ex.marching_tetrahedra(tsdf.cpu().numpy(), aabb,
                                              mask=weight.cpu().numpy() > 0)
        ex.export_obj(Path(args.output), verts, faces)
        print(f"wrote mesh ({len(verts)} verts, {len(faces)} faces) to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
