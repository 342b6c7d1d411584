"""Synthetic scenes with SAM and ClipSeg feature maps: a red ball on a
white background with cameras on a circle (:func:`write_scene`), and three
procedurally textured spheres on a ground plane under a gradient sky with
cameras on two rings (:func:`write_textured_scene`, the scene the quality
scripts train on).

The port's copy of ``samnerf_tpu/utils/synthetic.py``; both writers give
the JAX package's files byte for byte.  On-disk layout:
``transforms_{train,test}.json``, ``images/``, ``sam_features/*.npy``
([256, fh, fw]) and ``clipseg_features/*.pt`` (three [1025, 1, 64]
activations).  Host numpy: this is data, not the hot path.
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


def ray_sphere_hit(origins, directions, radius=BALL_RADIUS, center=None):
    """Hit mask and depth of rays against a sphere at ``center`` (the
    origin when None)."""
    if center is not None:
        origins = origins - center
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


_SPHERES = (  # centre, radius, (colour a, colour b), texture frequency
    (np.array([0.0, 0.0, 0.35]), 0.35,
     (np.array([0.85, 0.2, 0.15]), np.array([0.95, 0.85, 0.2])), 6.0),
    (np.array([0.5, -0.3, 0.15]), 0.15,
     (np.array([0.2, 0.35, 0.9]), np.array([0.9, 0.9, 0.95])), 10.0),
    (np.array([-0.45, 0.35, 0.2]), 0.2,
     (np.array([0.2, 0.75, 0.3]), np.array([0.6, 0.25, 0.7])), 8.0),
)


def _smooth_octaves(u, v, detail, octaves=4, base=3.0):
    """A continuous multi-octave texture in [0, 1]: sums of sine products
    at doubling frequencies, so reconstruction error tracks table capacity
    rather than step edges that no capacity resolves."""
    out = np.zeros_like(u)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        f = base * detail * (2.0 ** o)
        out = out + amp * np.sin(f * u + 1.7 * o) * np.sin(f * v - 0.9 * o)
        norm += amp
        amp *= 0.55
    return 0.5 + 0.5 * out / norm


def render_gt_image_textured(c2w, fx, fy, cx, cy, h, w, detail=1.0,
                             smooth_texture=False, supersample=1):
    """:func:`_render_gt_image_textured_impl`; ``supersample`` renders at an
    integer multiple and box-downsamples (anti-aliased ground truth, so
    sub-pixel edge error does not floor PSNR at every capacity alike)."""
    if supersample > 1:
        s = supersample
        img, hit = _render_gt_image_textured_impl(
            c2w, fx * s, fy * s, cx * s, cy * s, h * s, w * s, detail, smooth_texture)
        img = img.astype(np.float32).reshape(h, s, w, s, 3).mean((1, 3))
        hit = hit.reshape(h, s, w, s).mean((1, 3)) > 0.5
        return img.round().astype(np.uint8), hit
    return _render_gt_image_textured_impl(c2w, fx, fy, cx, cy, h, w, detail,
                                          smooth_texture)


def _render_gt_image_textured_impl(c2w, fx, fy, cx, cy, h, w, detail=1.0,
                                   smooth_texture=False):
    """Analytic render of three textured spheres on a checkerboard (or
    smooth-textured) ground plane under a gradient sky, with Lambertian
    shading from a fixed light.  Returns (uint8 image, hit mask of the
    primary sphere)."""
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack([(xx - cx) / fx, -(yy - cy) / fy, -np.ones_like(xx)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs.reshape(-1, 3)
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)

    best_t = np.full(dirs.shape[0], 1e6)
    # the sky: a gradient by elevation
    img = (np.array([0.55, 0.65, 0.9])[None]
           + 0.3 * dirs[:, 2:3] * np.array([0.3, 0.2, -0.2])[None])

    # the ground plane z = 0
    tz = np.where(dirs[:, 2] < -1e-6,
                  -origins[:, 2] / np.where(np.abs(dirs[:, 2]) < 1e-6, 1e-6, dirs[:, 2]),
                  1e6)
    pz = origins + tz[:, None] * dirs
    in_plane = (tz > 0) & (np.abs(pz[:, 0]) < 1.6) & (np.abs(pz[:, 1]) < 1.6)
    cf = 3 * detail
    if smooth_texture:
        tex = _smooth_octaves(pz[:, 0], pz[:, 1], detail)[:, None]
        plane_col = (tex * np.array([0.85, 0.85, 0.8])[None]
                     + (1 - tex) * np.array([0.25, 0.22, 0.2])[None])
    else:
        checker = ((np.floor(pz[:, 0] * cf) + np.floor(pz[:, 1] * cf)) % 2)
        plane_col = np.where(checker[:, None] > 0.5, np.array([0.85, 0.85, 0.8])[None],
                             np.array([0.25, 0.22, 0.2])[None])
    use = in_plane & (tz < best_t)
    img = np.where(use[:, None], plane_col, img)
    best_t = np.where(use, tz, best_t)

    primary_hit = None
    for center, rad, (ca, cb), freq in _SPHERES:
        hit, t = ray_sphere_hit(origins, dirs, radius=rad, center=center)
        p = origins + t[:, None] * dirs - center
        theta = np.arctan2(p[:, 1], p[:, 0])
        phi = np.arccos(np.clip(p[:, 2] / rad, -1, 1))
        if smooth_texture:
            tex = _smooth_octaves(theta * rad, phi * rad, detail * freq / 3.0)[:, None]
            col = tex * ca[None] + (1 - tex) * cb[None]
        else:
            stripe = (np.sin(freq * detail * theta) * np.sin(freq * detail * phi)) > 0
            col = np.where(stripe[:, None], ca[None], cb[None])
        light = np.array([0.5, -0.7, 0.9])
        light = light / np.linalg.norm(light)
        n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
        shade = 0.4 + 0.6 * np.clip(n @ light, 0, 1)
        col = col * shade[:, None]
        use = hit & (t < best_t)
        img = np.where(use[:, None], col, img)
        best_t = np.where(use, t, best_t)
        if primary_hit is None:       # the first sphere's mask
            primary_hit = use

    img = np.clip(img, 0.0, 1.0).reshape(h, w, 3)
    return (img * 255).astype(np.uint8), primary_hit.reshape(h, w)


def _write_features(out_dir: Path, stem: str, hit: np.ndarray, h: int, w: int,
                    feature_long_side: int) -> None:
    """The procedural targets of a view: SAM +1 inside ``hit`` and -1
    outside on every channel, [256, fh, fw]; ClipSeg three [1025, 1, 64]
    activations, token 0 the CLS token."""
    fh = int(np.ceil(h / w * feature_long_side)) if h < w else feature_long_side
    fw = feature_long_side if h <= w else int(np.ceil(w / h * feature_long_side))
    ys = np.linspace(0, h - 1, fh).astype(int)
    xs = np.linspace(0, w - 1, fw).astype(int)
    feat = np.where(hit[np.ix_(ys, xs)][None], 1.0, -1.0) * np.ones((256, 1, 1))
    np.save(out_dir / "sam_features" / f"{stem}.npy", feat.astype(np.float32))
    ys32 = np.linspace(0, h - 1, 32).astype(int)
    xs32 = np.linspace(0, w - 1, 32).astype(int)
    g = hit[np.ix_(ys32, xs32)].astype(np.float32) * 2 - 1
    acts = [torch.from_numpy(np.concatenate(
        [np.zeros((1, 1, 64), np.float32),
         np.repeat(g.reshape(1024, 1, 1), 64, axis=2)])) for _ in range(3)]
    torch.save({"activations": acts, "visual_q": None},
               out_dir / "clipseg_features" / f"{stem}.pt")


def write_textured_scene(out_dir: Path, num_train: int = 24, num_test: int = 4,
                         h: int = 128, w: int = 128, radius: float = 2.2,
                         with_features: bool = False, feature_long_side: int = 16,
                         detail: float = 1.0, smooth_texture: bool = False,
                         supersample: int = 1) -> Path:
    """Write the textured scene in samnerf layout: cameras on two rings
    (elevations 0.7 and 1.3, alternating) looking at (0, 0, 0.25),
    ``fx = fy = 0.9 w``; the feature maps follow the primary sphere."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    if with_features:
        (out_dir / "sam_features").mkdir(exist_ok=True)
        (out_dir / "clipseg_features").mkdir(exist_ok=True)
    fx = fy = 0.9 * w
    cx, cy = w / 2.0, h / 2.0
    n_total = num_train + num_test
    frames = []
    for i in range(n_total):
        ang = 2 * np.pi * i / n_total
        elev = 0.7 if i % 2 == 0 else 1.3
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), elev])
        c2w = look_at_c2w(pos, np.array([0.0, 0.0, 0.25]))
        img, hit = render_gt_image_textured(c2w, fx, fy, cx, cy, h, w, detail=detail,
                                            smooth_texture=smooth_texture,
                                            supersample=supersample)
        name = f"frame_{i:05d}.png"
        Image.fromarray(img).save(out_dir / "images" / name)
        frames.append({"file_path": f"images/{name}", "transform_matrix": c2w.tolist()})
        if with_features:
            _write_features(out_dir, f"frame_{i:05d}", hit, h, w, feature_long_side)
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "h": h, "w": w}
    (out_dir / "transforms_train.json").write_text(
        json.dumps(dict(meta, frames=frames[:num_train])))
    (out_dir / "transforms_test.json").write_text(
        json.dumps(dict(meta, frames=frames[num_train:])))
    return out_dir


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
            _write_features(out_dir, f"frame_{i:05d}", hit, h, w, feature_long_side)
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "h": h, "w": w}
    (out_dir / "transforms_train.json").write_text(
        json.dumps(dict(meta, frames=frames[:num_train])))
    (out_dir / "transforms_test.json").write_text(
        json.dumps(dict(meta, frames=frames[num_train:])))
    return out_dir
