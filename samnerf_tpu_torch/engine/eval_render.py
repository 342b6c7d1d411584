"""Full-image rendering: rgb plus the 64x64 SAM and 32x32 ClipSeg feature
grids, in fixed-size ray chunks.

Counterpart of ``samnerf_tpu/engine/eval_render.py`` (the fused feature
path): the feature grids reuse the rgb pass's top-k samples instead of
re-running proposals and the nerf field on separate ray grids.  The loop
over chunks replaces ``lax.map``.  The pixel stream is 2D-blocked like the
JAX package's so both packages see the same chunks.  A baked occupancy
grid (``occ``; :func:`bake_occupancy`) culls empty space in every chunk.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.ops.occupancy import (ServeOccupancy, cells_from_density,
                                             grid_cell_positions, pack_serve_occupancy)

PIXEL_BLOCK = 32
"""Side of the 2D pixel blocks of the ray stream (32x32 = 1024 rays)."""


def get_feature_size(h: int, w: int, largesize: int = 64) -> Tuple[int, int]:
    """SAM's 64x64-embedding aspect logic; h == w gives (largesize,)*2."""
    if h < w:
        return int(math.ceil(h / w * largesize)), largesize
    if h > w:
        return largesize, int(math.ceil(w / h * largesize))
    return largesize, largesize


def _chunked_coords(h: int, w: int, chunk: int) -> np.ndarray:
    """Row-major (row, col) coords padded to whole chunks: [n, chunk, 2]."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([yy, xx], -1).reshape(-1, 2).astype(np.float32)
    pad = (-coords.shape[0]) % chunk
    if pad:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad, 1))])
    return coords.reshape(-1, chunk, 2)


def _blocked_coords(h: int, w: int, chunk: int, bs: int = PIXEL_BLOCK):
    """Coords in 2D-block order, [n_chunks, chunk, 2], and ``unflatten``
    (flat [>=h*w, C] -> [h, w, C]); row-major when blocks do not tile."""
    if h % bs or w % bs or chunk % (bs * bs):
        def unflatten(flat):
            return flat[:h * w].reshape(h, w, flat.shape[-1])
        return _chunked_coords(h, w, chunk), unflatten
    bh, bw = h // bs, w // bs
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([yy, xx], -1).astype(np.float32)
    grid = grid.reshape(bh, bs, bw, bs, 2).transpose(0, 2, 1, 3, 4).reshape(-1, 2)
    pad = (-grid.shape[0]) % chunk
    if pad:
        grid = np.concatenate([grid, np.tile(grid[-1:], (pad, 1))])

    def unflatten(flat):
        c = flat.shape[-1]
        x = flat[:h * w].reshape(bh, bw, bs, bs, c)
        return x.permute(0, 2, 1, 3, 4).reshape(h, w, c)

    return grid.reshape(-1, chunk, 2), unflatten


def _feature_grid_rays(h: int, w: int, fh: int, fw: int, ps: int,
                       bs: int = PIXEL_BLOCK):
    """Patch-major linspace ray grid in 2D-patch-block order, [fh*fw*ps*ps,
    2] float, and ``unflatten`` (patch feats [>=fh*fw, C] -> [fh, fw, C])."""
    hi = np.linspace(0, h - 1, fh * ps)
    wi = np.linspace(0, w - 1, fw * ps)
    hh, ww = np.meshgrid(hi, wi, indexing="ij")
    grid = np.stack([hh, ww], -1).reshape(fh, ps, fw, ps, 2).transpose(0, 2, 1, 3, 4)
    pb = max(bs // ps, 1)
    if fh % pb == 0 and fw % pb == 0 and pb > 1:
        gh, gw = fh // pb, fw // pb
        grid = grid.reshape(gh, pb, gw, pb, ps, ps, 2).transpose(0, 2, 1, 3, 4, 5, 6)

        def unflatten(flat):
            c = flat.shape[-1]
            x = flat[:fh * fw].reshape(gh, gw, pb, pb, c)
            return x.permute(0, 2, 1, 3, 4).reshape(fh, fw, c)
    else:
        def unflatten(flat):
            return flat[:fh * fw].reshape(fh, fw, flat.shape[-1])
    return grid.reshape(-1, 2).astype(np.float32), unflatten


def _stream_index(h: int, w: int, chunk: int, bs: int = PIXEL_BLOCK):
    """(row, col) -> position in the :func:`_blocked_coords` ray stream."""
    if h % bs or w % bs or chunk % (bs * bs):
        def index(r, c):
            return r * w + c
        return index
    bw = w // bs

    def index(r, c):
        return ((r // bs) * bw + c // bs) * bs * bs + (r % bs) * bs + (c % bs)
    return index


def _fused_feature_eval(model: SAMModel, cameras: Cameras, cam_idx: int,
                        w_flat: torch.Tensor, mid_flat: torch.Tensor,
                        px_coords: torch.Tensor, idx: torch.Tensor,
                        get_features, rays_per_call: int, k_top: int,
                        group: int = 1) -> Dict[str, torch.Tensor]:
    """Feature rendering on the rgb pass's top-k samples: ``w_flat`` [N, K,
    1] / ``mid_flat`` [N, K] from the rgb stream, ``idx`` [M] maps each
    feature ray to its pixel ray there.  Rays are padded to whole calls of
    ``rays_per_call`` by repeating the last ``group`` rays (conv patches);
    callers slice the padding off."""
    wk, mid = w_flat[idx], mid_flat[idx]
    rb = generate_rays(cameras, torch.full_like(idx, cam_idx), px_coords)
    pos = rb.origins[:, None, :] + rb.directions[:, None, :] * mid[..., None]
    pad = (-pos.shape[0]) % rays_per_call
    if pad:
        reps = pad // group
        pos = torch.cat([pos, pos[-group:].repeat(reps, 1, 1)])
        wk = torch.cat([wk, wk[-group:].repeat(reps, 1, 1)])
    res = [model.features_from_topk(p, w, get_features, cull=True)
           for p, w in zip(pos.split(rays_per_call), wk.split(rays_per_call))]
    return {k: torch.cat([r[k] for r in res]) for k in res[0]}


class ImageRenderer:
    """Renders frames of one resolution set through a shared model."""

    def __init__(self, model: SAMModel, chunk: int = 1 << 15):
        self.model = model
        self.cfg = model.config
        self.chunk = chunk
        self._plans = {}

    def _plan(self, h: int, w: int, features: Tuple[str, ...], device):
        """Static per-(resolution, features, device) coords and indices."""
        key = (h, w, features, str(device))
        if key in self._plans:
            return self._plans[key]
        cfg, chunk = self.cfg, self.chunk
        rgb_np, rgb_unflatten = _blocked_coords(h, w, chunk)
        plan = {"rgb": (torch.as_tensor(rgb_np, device=device), rgb_unflatten)}
        idx_of = _stream_index(h, w, chunk)
        if "sam" in features and cfg.distill_sam:
            fh, fw = get_feature_size(h, w)
            grid, unflatten = _feature_grid_rays(h, w, fh, fw, cfg.patch_size)
            px = np.rint(grid).astype(np.int64)
            plan["sam"] = (torch.as_tensor(px.astype(np.float32), device=device),
                           torch.as_tensor(idx_of(px[:, 0], px[:, 1]), device=device),
                           unflatten)
        if "clipseg" in features and cfg.distill_sam and cfg.use_clipseg_feature:
            hh, ww = np.meshgrid(np.linspace(0, h - 1, 32), np.linspace(0, w - 1, 32),
                                 indexing="ij")
            px = np.rint(np.stack([hh, ww], -1).reshape(-1, 2)).astype(np.int64)
            plan["clipseg"] = (torch.as_tensor(px.astype(np.float32), device=device),
                               torch.as_tensor(idx_of(px[:, 0], px[:, 1]),
                                               device=device), None)
        self._plans[key] = plan
        return plan

    def render_image(self, cameras: Cameras, camera_index: int,
                     width: Optional[int] = None, height: Optional[int] = None,
                     features: Tuple[str, ...] = (), crop_aabb=None,
                     crop_bg=None, occ: Optional[ServeOccupancy] = None
                     ) -> Dict[str, np.ndarray]:
        """Render one camera (the camera's size unless given) with depth,
        accumulation and the per-level median depths; returns host numpy
        arrays.  ``crop_aabb`` [2, 3], ``crop_bg`` [3] and ``occ`` as in
        :meth:`render_image_device`."""
        out = self.render_image_device(cameras, camera_index,
                                       width or cameras.width,
                                       height or cameras.height, features,
                                       crop_aabb=crop_aabb, crop_bg=crop_bg, occ=occ)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.no_grad()
    def render_image_device(self, cameras: Cameras, camera_index: int,
                            width: int, height: int,
                            features: Tuple[str, ...] = (),
                            minimal: bool = False, crop_aabb=None,
                            crop_bg=None, occ: Optional[ServeOccupancy] = None
                            ) -> Dict[str, torch.Tensor]:
        """Render one camera on the model's device.  ``minimal`` returns rgb
        and the requested feature grids only (the serve fast path);
        otherwise depth, accumulation and per-level median depths too.
        ``crop_aabb`` [2, 3] (min, max corner): the viewer's crop box; the
        rgb pass's rays are bounded to it and its empty space takes the
        background ``crop_bg`` [3] (black unless given).  ``occ``: a baked
        occupancy grid on the same device; its empty space is culled."""
        cfg, chunk = self.cfg, self.chunk
        device = cameras.camera_to_worlds.device
        plan = self._plan(height, width, tuple(features), device)
        rgb_coords, rgb_unflatten = plan["rgb"]
        fuse = "sam" in plan or "clipseg" in plan
        bg = None
        if crop_aabb is not None:
            crop_aabb = torch.as_tensor(crop_aabb, dtype=torch.float32, device=device)
            bg = (torch.zeros(3, device=device) if crop_bg is None else
                  torch.as_tensor(crop_bg, dtype=torch.float32, device=device))
        outs = []
        for c in rgb_coords:
            rb = generate_rays(cameras, torch.full((c.shape[0],), camera_index,
                                                   device=device), c,
                               aabb_box=crop_aabb)
            outs.append(self.model(rb, bg_color=bg, return_topk=fuse, occupancy=occ))
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        outputs = {"rgb": rgb_unflatten(out["rgb"])}
        if not minimal:
            for k in ["depth", "accumulation"] + [
                    f"prop_depth_{i}" for i in range(cfg.num_proposal_iterations)]:
                outputs[k] = rgb_unflatten(out[k])
        k_top = cfg.num_sam_samples
        if "sam" in plan:
            px, idx, unflatten = plan["sam"]
            ps = cfg.patch_size
            rpc = min(max(chunk // (ps * ps), 1) * ps * ps, idx.shape[0])
            feats = _fused_feature_eval(self.model, cameras, camera_index,
                                        out["topk_w"], out["topk_mid"], px, idx,
                                        ("sam",), rpc, k_top, group=ps * ps)
            outputs["sam"] = unflatten(feats["sam"])
        if "clipseg" in plan:
            px, idx, _ = plan["clipseg"]
            feats = _fused_feature_eval(self.model, cameras, camera_index,
                                        out["topk_w"], out["topk_mid"], px, idx,
                                        ("clipseg",), 1024, k_top)
            outputs["clipseg"] = feats["clipseg"][:1024].reshape(32, 32, -1)
        return outputs


@torch.no_grad()
def bake_density_grid(model: SAMModel, res: int = 0, sub: int = 2,
                      chunk: int = 1 << 17) -> np.ndarray:
    """The nerf field's density at ``sub``^3 points in each cell of a
    ``res``^3 grid in contracted unit space (``res`` 0: the model's
    ``occ_res``), max-pooled per cell: [res, res, res] numpy.  The points
    go through ``density_at_unit`` in chunks of ``chunk``, the last padded
    with the sentinel 0.5."""
    res = res or model.config.occ_res
    device = model.fields.encoding.table.device
    pts = torch.as_tensor(grid_cell_positions(res, sub), device=device)
    n = pts.shape[0]
    pad = (-n) % chunk
    if pad:
        pts = torch.cat([pts, pts.new_full((pad, 3), 0.5)])
    d = torch.cat([model.fields.density_at_unit(p) for p in pts.split(chunk)])
    d = d.reshape(-1)[:n].float().cpu().numpy()
    return d.reshape(res ** 3, sub ** 3).max(axis=1).reshape(res, res, res)


def occupancy_from_cells(cell_d: np.ndarray, threshold: float = 0.01, device="cuda"):
    """Threshold a baked density grid and pack it on ``device``: (the
    :class:`~samnerf_tpu_torch.ops.occupancy.ServeOccupancy`, the occupied
    fraction of cells)."""
    cells = cells_from_density(torch.as_tensor(np.asarray(cell_d)), threshold).numpy()
    return pack_serve_occupancy(cells, device=device), float(cells.mean())


def bake_occupancy(model: SAMModel, res: int = 0, threshold: float = 0.01,
                   sub: int = 2, chunk: int = 1 << 17):
    """A serve occupancy grid from a trained model, on its device:
    :func:`bake_density_grid`, thresholded and packed with a one-cell
    dilation.  Returns (grid, occupied fraction)."""
    cell_d = bake_density_grid(model, res=res, sub=sub, chunk=chunk)
    return occupancy_from_cells(cell_d, threshold,
                                device=model.fields.encoding.table.device)
