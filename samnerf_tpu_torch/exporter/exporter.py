"""Geometry export from a trained run: point clouds, TSDF meshes and
Poisson meshes.

Counterpart of ``samnerf_tpu/exporter/exporter.py``.  The writers
(:func:`export_ply`, :func:`export_obj`), the back-projections
(:func:`backproject_depth`, :func:`depth_to_oriented_points`) and the mesh
extraction (:func:`marching_tetrahedra`: six tetrahedra per cube, no
table) are the JAX package's numpy code, so they give the same bytes, text
and meshes.  The dense parts run in torch on the caller's device: the
TSDF volume (:func:`tsdf_init`, :func:`tsdf_integrate`) and the screened
Poisson solve (:func:`poisson_indicator`: a trilinear splat of the
oriented normals, their divergence, and 200 conjugate-gradient steps of
``(laplacian - screen / n^2) chi = div V`` that stay on the device; the
one host read is the iso value).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


# --- PLY / OBJ writers ---------------------------------------------------------


def export_ply(path: Path, points: np.ndarray,
               colors: Optional[np.ndarray] = None,
               normals: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY (the layout open3d writes): the bytes of
    the JAX package's per-point writer, written as one structured array."""
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = "\n".join(["ply", "format binary_little_endian 1.0",
                        f"element vertex {n}", *props, "end_header", ""])
    fields = [("xyz", "<f4", 3)]
    if normals is not None:
        fields.append(("normal", "<f4", 3))
    if colors is not None:
        fields.append(("rgb", "u1", 3))
    rows = np.empty(n, dtype=np.dtype(fields))     # packed: no padding
    rows["xyz"] = points.astype(np.float32)
    if normals is not None:
        rows["normal"] = normals.astype(np.float32)
    if colors is not None:
        rows["rgb"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rows.tobytes())


def export_obj(path: Path, vertices: np.ndarray, faces: np.ndarray,
               vertex_colors: Optional[np.ndarray] = None) -> None:
    """Wavefront OBJ, faces 1-indexed."""
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            if vertex_colors is not None:
                c = vertex_colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


# --- Point clouds from rendered views ------------------------------------------


def backproject_depth(depth: np.ndarray, rgb: np.ndarray, accumulation: np.ndarray,
                      intrin: np.ndarray, c2w: np.ndarray,
                      min_accumulation: float = 0.8,
                      stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """One rendered view -> (points [M, 3], colors [M, 3]) of the pixels
    whose accumulation exceeds ``min_accumulation``; OpenGL camera (-z
    forward, y up), as ray generation."""
    h, w = depth.shape[:2]
    yy, xx = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[yy, xx, 0] if depth.ndim == 3 else depth[yy, xx]
    acc = accumulation[yy, xx, 0] if accumulation.ndim == 3 else accumulation[yy, xx]
    keep = acc > min_accumulation
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    x = (xx + 0.5 - cx) / fx
    y = -(yy + 0.5 - cy) / fy
    dirs = np.stack([x, y, -np.ones_like(x)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_w = dirs @ c2w[:3, :3].T
    pts = c2w[:3, 3][None, None] + dirs_w * d[..., None]
    cols = rgb[yy, xx]
    return pts[keep], cols[keep]


def depth_to_oriented_points(depth: np.ndarray, accumulation: np.ndarray,
                             intrin: np.ndarray, c2w: np.ndarray,
                             min_accumulation: float = 0.5):
    """A depth map -> (points [M, 3], normals [M, 3]) for Poisson meshing:
    normals from the cross product of the image-space depth gradients,
    flipped to face the camera."""
    depth = depth[..., 0] if depth.ndim == 3 else depth
    acc = accumulation[..., 0] if accumulation.ndim == 3 else accumulation
    h, w = depth.shape
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs_cam = np.stack([(xx - cx) / fx, -(yy - cy) / fy, -np.ones_like(xx)], -1)
    dirs = dirs_cam @ np.asarray(c2w)[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = np.asarray(c2w)[:3, 3][None, None] + depth[..., None] * dirs

    dpdx = np.gradient(pts, axis=1)
    dpdy = np.gradient(pts, axis=0)
    n = np.cross(dpdx, dpdy)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    to_cam = np.asarray(c2w)[:3, 3][None, None] - pts
    flip = np.sum(n * to_cam, axis=-1, keepdims=True) < 0
    n = np.where(flip, -n, n)

    keep = acc > min_accumulation
    return pts[keep], n[keep]


# --- TSDF fusion ----------------------------------------------------------------


def tsdf_init(resolution: int, device="cuda"):
    """(tsdf ones, weight zeros [R, R, R], color zeros [R, R, R, 3]) f32."""
    shape = (resolution,) * 3
    return (torch.ones(shape, device=device), torch.zeros(shape, device=device),
            torch.zeros(shape + (3,), device=device))


def tsdf_integrate(state, depth: torch.Tensor, rgb: torch.Tensor, intrin: torch.Tensor,
                   c2w: torch.Tensor, aabb: torch.Tensor, trunc: float = 0.05):
    """Integrate one rendered view into the dense TSDF (open3d
    ``ScalableTSDFVolume.integrate``'s update): every voxel centre is
    projected into the view, and where it lands inside the image, in front
    of the camera and no more than ``trunc`` behind the surface, its
    truncated signed distance and the pixel's colour are averaged in with
    weight 1.  depth [H, W], rgb [H, W, 3], intrin [3, 3], c2w [3|4, 4],
    aabb [2, 3], all on the state's device."""
    tsdf, weight, color = state
    res = tsdf.shape[0]
    dev = tsdf.device
    idx = torch.arange(res, device=dev)
    gx, gy, gz = torch.meshgrid(idx, idx, idx, indexing="ij")
    vox = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    world = aabb[0] + (vox + 0.5) / res * (aabb[1] - aabb[0])

    rot = c2w[:3, :3]
    t = c2w[:3, 3]
    cam = (world - t) @ rot               # the inverse rotation
    z = -cam[:, 2]
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    u = cam[:, 0] / torch.clamp_min(z, 1e-6) * fx + cx
    v = -cam[:, 1] / torch.clamp_min(z, 1e-6) * fy + cy
    h, w = depth.shape[:2]
    # truncated toward zero, then clipped; bounding the float first keeps
    # voxels far outside the view inside int32 and changes no clipped index
    ui = torch.clamp(torch.clamp(u, -1.0, float(w)).to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(torch.clamp(v, -1.0, float(h)).to(torch.int32), 0, h - 1).long()
    valid = (z > 1e-4) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = depth.reshape(h * w)[vi * w + ui]
    c = rgb.reshape(h * w, 3)[vi * w + ui]
    sdf = (d - z) / trunc
    upd = valid & (sdf > -1.0) & (d > 0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    wnew = upd.to(torch.float32)
    w_old = weight.reshape(-1)
    w_tot = w_old + wnew
    safe = torch.clamp_min(w_tot, 1e-6)
    tsdf_new = (tsdf.reshape(-1) * w_old + sdf * wnew) / safe
    col_new = (color.reshape(-1, 3) * w_old[:, None] + c * wnew[:, None]) / safe[:, None]
    return (tsdf_new.reshape(tsdf.shape), w_tot.reshape(weight.shape),
            col_new.reshape(color.shape))


# --- Marching tetrahedra ---------------------------------------------------------

# cube corner offsets, and the 6-tetrahedra decomposition of a cube
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def marching_tetrahedra(values: np.ndarray, aabb: np.ndarray, level: float = 0.0,
                        mask: Optional[np.ndarray] = None):
    """The iso-surface of a dense scalar grid values [R, R, R] (numpy) ->
    (vertices [V, 3] world, faces [F, 3]).  Each cube (those of ``mask``
    [R, R, R] when given) is split into 6 tetrahedra; a tetrahedron with a
    sign change emits 1 or 2 triangles from interpolated edge crossings."""
    res = values.shape[0]
    v = values - level
    idx = np.arange(res - 1)
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    base = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # [C, 3]
    if mask is not None:
        mcube = mask[:-1, :-1, :-1].reshape(-1)
        base = base[mcube]
    corner_idx = base[:, None, :] + _CORNERS[None]  # [C, 8, 3]
    cv = v[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    verts = []
    faces = []
    scale = (aabb[1] - aabb[0]) / res

    def emit(p):
        verts.append(p)
        return len(verts) - 1

    for tet in _TETS:
        tv = cv[:, tet]                       # [C, 4]
        tp = corner_idx[:, tet]               # [C, 4, 3]
        n_in = (tv < 0).sum(axis=1)
        for cnt in (1, 2, 3):
            for ci in np.nonzero(n_in == cnt)[0]:
                vv = tv[ci]
                pp = tp[ci].astype(np.float64)
                ins = np.nonzero(vv < 0)[0]
                outs = np.nonzero(vv >= 0)[0]

                def crossing(a, b):
                    ta = vv[a]
                    tb = vv[b]
                    alpha = ta / (ta - tb + 1e-12)
                    p = pp[a] + alpha * (pp[b] - pp[a])
                    return emit(aabb[0] + (p + 0.5) * scale)

                if cnt == 1:
                    a = ins[0]
                    faces.append([crossing(a, outs[0]), crossing(a, outs[1]),
                                  crossing(a, outs[2])])
                elif cnt == 3:
                    a = outs[0]
                    faces.append([crossing(ins[0], a), crossing(ins[1], a),
                                  crossing(ins[2], a)])
                else:  # 2 in, 2 out: a quad, two triangles
                    a, b = ins
                    c, d = outs
                    q = [crossing(a, c), crossing(a, d), crossing(b, d), crossing(b, c)]
                    faces.append([q[0], q[1], q[2]])
                    faces.append([q[0], q[2], q[3]])
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.asarray(verts), np.asarray(faces, np.int64)


# --- Screened Poisson ------------------------------------------------------------


def _corner_weights(pts01: torch.Tensor, n: int):
    """The 8 (weight [M], index [M, 3]) pairs of trilinear interpolation
    on an n^3 grid over [0, 1]^3, indices clipped to the grid."""
    p = pts01 * (n - 1)
    f = torch.floor(p)
    d = p - f
    base = f.to(torch.int64)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((d[:, 0] if cx else 1 - d[:, 0]) * (d[:, 1] if cy else 1 - d[:, 1])
                     * (d[:, 2] if cz else 1 - d[:, 2]))
                off = torch.tensor([cx, cy, cz], device=pts01.device)
                yield w, torch.clamp(base + off, 0, n - 1)


def _splat_trilinear(grid: torch.Tensor, pts01: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Trilinear scatter-add of per-point values vals [M, C] into grid
    [N, N, N, C] (a new tensor; the adds of one corner that meet in a cell
    accumulate in an unspecified order)."""
    grid = grid.clone()
    for w, idx in _corner_weights(pts01, grid.shape[0]):
        grid.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), w[:, None] * vals,
                        accumulate=True)
    return grid


def _sample_trilinear(grid: torch.Tensor, pts01: torch.Tensor) -> torch.Tensor:
    out = 0.0
    for w, idx in _corner_weights(pts01, grid.shape[0]):
        out = out + w * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def poisson_indicator(points: np.ndarray, normals: np.ndarray, aabb: np.ndarray,
                      resolution: int = 96, screen: float = 4.0, cg_iters: int = 200,
                      device="cuda") -> torch.Tensor:
    """The indicator chi [n, n, n] of the screened Poisson problem,
    shifted so that its mean over the input samples is 0 (the surface).

    The oriented normals are splatted trilinearly into a vector field V,
    and ``(laplacian - screen / n^2) chi = div V`` (central differences,
    periodic as ``torch.roll``) is solved by ``cg_iters`` conjugate
    gradient steps on ``device`` with no host read; then the mean of chi at
    the samples is read once and subtracted.  points [M, 3] world, normals
    [M, 3] outward, aabb [2, 3], numpy."""
    aabb = np.asarray(aabb, np.float32)
    span = aabb[1] - aabb[0]
    pts01 = torch.as_tensor(((points - aabb[0]) / span).astype(np.float32), device=device)
    nrm = torch.as_tensor((normals / (np.linalg.norm(normals, axis=-1, keepdims=True)
                                      + 1e-12)).astype(np.float32), device=device)
    n = resolution
    vfield = _splat_trilinear(torch.zeros((n, n, n, 3), device=device), pts01, nrm)

    def ddx(a, axis):
        return (torch.roll(a, -1, axis) - torch.roll(a, 1, axis)) * 0.5

    rhs = ddx(vfield[..., 0], 0) + ddx(vfield[..., 1], 1) + ddx(vfield[..., 2], 2)
    alpha = screen / (n * n)

    def apply_a(x):
        out = -6.0 * x
        for ax in (0, 1, 2):
            out = out + torch.roll(x, 1, ax) + torch.roll(x, -1, ax)
        return out - alpha * x

    tiny = torch.tensor(1e-20, device=device)
    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    rs = torch.sum(rhs * rhs)
    for _ in range(cg_iters):
        ap = apply_a(p)
        denom = torch.sum(p * ap)
        a = rs / torch.where(torch.abs(denom) < 1e-20, tiny, denom)
        x = x + a * p
        r = r - a * ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.where(rs < 1e-20, tiny, rs)
        p = p * beta + r
        rs = rs_new
    iso = float(torch.mean(_sample_trilinear(x, pts01)))
    return x - iso


def poisson_reconstruct(points: np.ndarray, normals: np.ndarray, aabb: np.ndarray,
                        resolution: int = 96, screen: float = 4.0, cg_iters: int = 200,
                        device="cuda"):
    """Screened Poisson surface reconstruction on a dense grid (the
    dense-grid stand-in for open3d's octree Poisson): the zero set of
    :func:`poisson_indicator` through :func:`marching_tetrahedra`.
    Returns (vertices [V, 3], faces [F, 3])."""
    chi = poisson_indicator(points, normals, aabb, resolution, screen, cg_iters, device)
    return marching_tetrahedra(chi.cpu().numpy(), np.asarray(aabb, np.float32))


def export_poisson(path: Path, points: np.ndarray, normals: np.ndarray,
                   aabb: np.ndarray, resolution: int = 96, device="cuda") -> Path:
    """The Poisson mesh of oriented points, written as OBJ."""
    verts, faces = poisson_reconstruct(points, normals, aabb, resolution, device=device)
    export_obj(Path(path), verts, faces)
    return Path(path)
