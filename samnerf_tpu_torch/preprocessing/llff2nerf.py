"""LLFF ``poses_bounds.npy`` -> nerfstudio ``transforms_{train,val,test}.json``.

The port's copy of ``samnerf_tpu/preprocessing/llff2nerf.py`` (host
numpy): LLFF's [down, right, back] axes to nerfstudio's, the mean up
vector rotated to +z, the poses centred on the point nearest to every
pair of optical axes and scaled to a mean distance of 4, and every
``--hold``-th image held out.

Usage: ``python -m samnerf_tpu_torch.preprocessing.llff2nerf <path> --images
images_8 --downscale 8 --hold 8``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from pathlib import Path

import numpy as np


def closest_point_2_lines(oa, da, ob, db):
    """Point minimizing distance to two rays (``llff2nerf.py:14-27``)."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = np.linalg.norm(c) ** 2
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta = min(ta, 0)
    tb = min(tb, 0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def rotmat(a, b):
    """Rotation taking a to b (``llff2nerf.py:29-37``)."""
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = np.dot(a, b)
    if c < -1 + 1e-10:
        return rotmat(a + np.random.uniform(-1e-2, 1e-2, 3), b)
    s = np.linalg.norm(v)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat.dot(kmat) * ((1 - c) / (s ** 2 + 1e-10))


def convert_llff(path: Path, images_dir: str = "images_8",
                 downscale: float = 8, hold: int = 8) -> None:
    """``llff2nerf.py:96-201``."""
    path = str(path)
    if path[-1] != "/":
        path += "/"
    images = [f[len(path):] for f in
              sorted(glob.glob(os.path.join(path, images_dir, "*")))
              if f.lower().endswith(("png", "jpg", "jpeg"))]
    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    n = poses_bounds.shape[0]
    assert n == len(images), (n, len(images))

    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    h, w, fl = poses[0, :, -1]
    h, w, fl = h // downscale, w // downscale, fl / downscale

    # LLFF [down right back] -> [right up back] etc. (llff2nerf.py:115-127)
    poses = np.concatenate(
        [poses[..., 1:2], poses[..., 0:1], -poses[..., 2:3], poses[..., 3:4]], -1)
    last_row = np.tile(np.array([0, 0, 0, 1]), (len(poses), 1, 1))
    poses = np.concatenate([poses, last_row], axis=1)
    poses[:, 0:3, 1] *= -1
    poses[:, 0:3, 2] *= -1
    poses = poses[:, [1, 0, 2, 3], :]
    poses[:, 2, :] *= -1

    up = poses[:, 0:3, 1].sum(0)
    up = up / np.linalg.norm(up)
    r = np.pad(rotmat(up, np.array([0.0, 0.0, 1.0])), [0, 1])
    r[-1, -1] = 1
    poses = r @ poses

    # centroid via pairwise closest points (llff2nerf.py:137-150)
    totw, totp = 0.0, np.zeros(3)
    for i in range(n):
        mf = poses[i, :3, :]
        for j in range(i + 1, n):
            mg = poses[j, :3, :]
            p, wgt = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
            if wgt > 0.01:
                totp += p * wgt
                totw += wgt
    totp /= totw
    poses[:, :3, 3] -= totp
    avglen = np.linalg.norm(poses[:, :3, 3], axis=-1).mean()
    poses[:, :3, 3] *= 4.0 / avglen

    all_ids = np.arange(n)
    test_ids = all_ids[::hold]
    train_ids = np.array([i for i in all_ids if i not in test_ids])

    def frames_for(ids):
        return [{"file_path": images[i],
                 "transform_matrix": poses[i].tolist()} for i in ids]

    base = {
        "fl_x": fl, "fl_y": fl,
        "cx": w / 2, "cy": h / 2,
        "w": w, "h": h,
        "aabb_scale": 2,
    }
    for name, ids in (("train", train_ids), ("val", test_ids),
                      ("test", test_ids)):
        out = dict(base, frames=frames_for(ids))
        with open(os.path.join(path, f"transforms_{name}.json"), "w") as f:
            json.dump(out, f, indent=2)
    print(f"[INFO] wrote transforms_{{train,val,test}}.json "
          f"({len(train_ids)} train / {len(test_ids)} test)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("--images", type=str, default="images_8")
    p.add_argument("--downscale", type=float, default=8)
    p.add_argument("--hold", type=int, default=8)
    a = p.parse_args(argv)
    convert_llff(Path(a.path), a.images, a.downscale, a.hold)


if __name__ == "__main__":
    main()
