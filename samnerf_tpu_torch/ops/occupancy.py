"""Occupancy grids: the training-time grid of the model zoo's ngp methods,
and serve-time culling with a dense dilated grid in contracted unit space.

Counterpart of ``samnerf_tpu/ops/occupancy.py``.  Training half
(``occupancy_mask``, ``update_occupancy``): a dense [res^3] EMA of
sampled densities in a world-space box, thresholded into a 0/1 grid that
multiplies the density of samples in empty cells to zero.  Serve half
(``ServeOccupancy``, ``pack_serve_occupancy``, ``occupancy_live``,
``tile_live_points``, ``cells_from_density``, ``grid_cell_positions``).

Liveness is decided per tile of the JAX package's encode stream, so a
culled frame keeps exactly the samples the JAX package keeps: the fields
test tiles on a view of their points in that stream order
(:func:`stream_order`) and map the result back to their own [R, S] order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LANES = 128
"""The JAX hash kernel's lane width: the smallest tile it picks."""
SAMPLE_BLOCK = 1024
"""Rays per block of the JAX package's block-major point stream (a 32x32
pixel block of the serve path's 2D-tiled rays)."""
LIVE_TILE = 8192
"""The largest tile of points tested as one box."""


def occupancy_mask(grid: torch.Tensor, positions: torch.Tensor,
                   aabb: torch.Tensor) -> torch.Tensor:
    """Nearest-cell lookup: grid [res, res, res] 0/1, world positions
    [..., 3], aabb [2, 3] -> [..., 1]; 0 outside the box."""
    res = grid.shape[0]
    p = (positions - aabb[0]) / (aabb[1] - aabb[0])
    inside = ((p >= 0.0) & (p < 1.0)).all(dim=-1)
    ijk = torch.clamp((p * res).to(torch.int64), 0, res - 1)
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    return (grid.reshape(-1)[flat] * inside)[..., None]


def update_occupancy(grid_density: torch.Tensor, density_fn: Callable,
                     aabb: torch.Tensor, generator: Optional[torch.Generator] = None,
                     num_samples: int = 262144, ema: float = 0.95,
                     threshold: float = 0.01, idx: Optional[torch.Tensor] = None,
                     jitter: Optional[torch.Tensor] = None):
    """One EMA round of the training grid: ``num_samples`` random cells
    (``idx`` [n] in [0, res^3)), a random point in each (``jitter`` [n, 3]
    in [0, 1)), both drawn from ``generator`` unless given; each cell keeps
    the max of its decayed density and the fresh ``density_fn`` ([n, 3]
    world -> [n, 1]; run without gradient) at its points.  Returns (new
    grid_density [res^3], grid [res, res, res] f32 0/1 above
    ``threshold``).  The max is order-free, so the result is
    deterministic on any device."""
    cells = grid_density.shape[0]
    res = round(cells ** (1 / 3))
    device = grid_density.device
    if idx is None:
        idx = torch.randint(0, cells, (num_samples,), generator=generator, device=device)
    if jitter is None:
        jitter = torch.rand((idx.shape[0], 3), generator=generator, device=device)
    idx = idx.long()
    ijk = torch.stack([(idx // (res * res)) % res, (idx // res) % res, idx % res], dim=-1)
    pos = aabb[0] + (ijk + jitter) / res * (aabb[1] - aabb[0])
    with torch.no_grad():
        d = density_fn(pos)[..., 0].float()
    updated = (grid_density * ema).scatter_reduce(0, idx, d, "amax", include_self=True)
    occ = (updated > threshold).to(torch.float32).reshape(res, res, res)
    return updated, occ


class ServeOccupancy(NamedTuple):
    """Max-mip pyramid of the 27-neighbourhood-dilated cell grid.
    ``mips[k]`` is the flattened grid at resolution ``res >> k`` (down to
    3), on the device that renders; ``mips[0][cell(p)] > 0`` means some
    cell in the 3x3x3 neighbourhood of p's cell is occupied.  ``res``
    is the model's ``occ_res``.

    The rest serves the tile test, which reads every level with one
    gather and is host-bound (each of its torch calls costs more on the
    host than on the card): ``table``, the mips one after the other (each
    mip is a view of it), and on the same device each mip's resolution
    (``sizes`` [1, 1, K, 1] f32, ``limits`` = size - 1 as int64), cell
    strides (``strides`` [K, 1, 3]: size^2, size, 1), start in ``table``
    (``offsets`` [K, 1]) and the 8 box corners (``corners`` [8, 3], True
    where the corner takes the box's high cell).  No frame copies a
    constant to the device."""
    mips: Tuple[torch.Tensor, ...]
    table: torch.Tensor
    sizes: torch.Tensor
    limits: torch.Tensor
    strides: torch.Tensor
    offsets: torch.Tensor
    corners: torch.Tensor


def pack_serve_occupancy(occ_cells, device="cuda") -> ServeOccupancy:
    """[res, res, res] cell occupancy (0/1, unit-cube cells; numpy or a
    tensor) -> the dilated max-mip pyramid on ``device``."""
    occ = torch.as_tensor(np.asarray(occ_cells, np.float32), device=device)
    res = occ.shape[0]
    # a 3^3 max over the zero-padded grid: values are >= 0, so max_pool3d's
    # -inf padding gives the same maximum
    cur = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    levels, sizes = [], []
    r = res
    while r >= 3:
        levels.append(cur.reshape(-1))
        sizes.append(r)
        if r % 2 or r // 2 < 3:
            break
        r //= 2
        cur = cur.reshape(r, 2, r, 2, r, 2).amax((1, 3, 5))
    table = torch.cat(levels)
    size = np.asarray(sizes, np.int64)
    bits = np.arange(8)[:, None] >> np.array([2, 1, 0]) & 1

    def const(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ServeOccupancy(
        mips=tuple(table.split([s ** 3 for s in sizes])), table=table,
        sizes=const(size[None, None, :, None], torch.float32),
        limits=const(size[None, None, :, None] - 1),
        strides=const(np.stack([size * size, size, np.ones_like(size)], -1)[:, None, :]),
        offsets=const(np.cumsum(np.concatenate([[0], size[:-1] ** 3]))[:, None]),
        corners=const(bits, torch.bool))


def occupancy_live(occ: ServeOccupancy, p_unit: torch.Tensor, res: int) -> torch.Tensor:
    """[N, 3] contracted-unit positions -> [N, 1] float 0/1 liveness of
    each point's cell neighbourhood."""
    i = torch.clamp((p_unit * res).to(torch.int64), 0, res - 1)
    flat = (i[:, 0] * res + i[:, 1]) * res + i[:, 2]
    return occ.mips[0][flat][:, None].to(p_unit.dtype)


def pick_tile(n: int, cap: int = LIVE_TILE) -> int:
    """The JAX hash kernel's point tile: halve from ``cap`` while the tile
    is over 128 and does not divide n (``hash_pallas._pick_tile``)."""
    t = cap
    while t > LANES and n % t:
        t //= 2
    return t


def tile_live_points(occ: ServeOccupancy, p_unit: torch.Tensor, res: int,
                     tile: int = 0) -> torch.Tensor:
    """Per-tile liveness, broadcast per point: [N, 3] contracted-unit
    positions (in the JAX package's stream order) -> [N, 1] float 0/1.

    Each tile of ``pick_tile(N)`` consecutive points is tested as one box
    against the mips: it is dead only if the finest mip whose cells cover
    its box (at most 2 cells a side) has zeros at all 8 covering cells.
    A box wider than the coarsest mip's cells stays live.  When the tile
    does not divide N, every point is tested alone (:func:`occupancy_live`).
    Every mip's 8 cells are read in one gather (a loop over mips and
    corners costs hundreds of small launches per call).  Raises unless
    the grid's finest mip is ``res``^3."""
    if occ.mips and occ.mips[0].numel() != res ** 3:
        raise ValueError(f"a {round(occ.mips[0].numel() ** (1 / 3))}^3 occupancy grid "
                         f"for occ_res {res}")
    n = p_unit.shape[0]
    tile = tile or pick_tile(n)
    t = n // tile
    if t * tile != n or not occ.mips:
        return occupancy_live(occ, p_unit, res)
    pts = p_unit.reshape(t, tile, 3)
    # the same f32 products and truncations as one mip at a time
    box = torch.stack([pts.amin(dim=1), pts.amax(dim=1)], dim=1)[:, :, None]   # [t, 2, 1, 3]
    ij = torch.minimum(torch.clamp_min((box * occ.sizes).to(torch.int64), 0), occ.limits)
    lo, hi = ij[:, 0], ij[:, 1]                                     # [t, K, 3]
    fits = ((hi - lo) <= 1).all(dim=-1)                             # [t, K]
    c = torch.where(occ.corners, hi[:, :, None], lo[:, :, None])    # [t, K, 8, 3]
    cell = (c * occ.strides).sum(dim=-1) + occ.offsets              # [t, K, 8]
    v = torch.take(occ.table, cell).amax(dim=-1)                    # [t, K]
    # the finest mip whose cells cover the box decides; none: live
    first = torch.argmax(fits.to(p_unit.dtype), dim=-1, keepdim=True)
    decided = torch.gather(v, 1, first)[:, 0] > 0
    live = torch.where(fits.any(dim=-1), decided, True)
    return live.to(p_unit.dtype)[:, None].expand(t, tile).reshape(n, 1)


def stream_order(p: torch.Tensor) -> Tuple[torch.Tensor, Callable]:
    """[R, S, C] -> ([R*S, C] in the JAX package's encode stream order,
    ``unflatten`` ([R*S, C'] in that order -> [R, S, C'])).

    The JAX fields stream points block-major when R is a multiple of
    ``SAMPLE_BLOCK`` above it (each block of 1024 rays emits its samples
    depth by depth), else sample-major (``nerfacto_field
    ._flatten_sample_major``).  Reshapes and transposes only."""
    r, s, c = p.shape
    if r % SAMPLE_BLOCK == 0 and r > SAMPLE_BLOCK:
        nb = r // SAMPLE_BLOCK
        flat = p.reshape(nb, SAMPLE_BLOCK, s, c).transpose(1, 2).reshape(-1, c)

        def unflatten(h):
            return h.reshape(nb, s, SAMPLE_BLOCK, -1).transpose(1, 2).reshape(r, s, -1)
        return flat, unflatten
    flat = p.transpose(0, 1).reshape(-1, c)

    def unflatten(h):
        return h.reshape(s, r, -1).transpose(0, 1)
    return flat, unflatten


def stream_tile_live(occ: ServeOccupancy, p: torch.Tensor, res: int) -> torch.Tensor:
    """[R, S, 3] contracted-unit positions -> [R, S, 1] liveness with the
    JAX package's tiles (:func:`tile_live_points` on :func:`stream_order`)."""
    flat, unflatten = stream_order(p)
    return unflatten(tile_live_points(occ, flat, res))


def cells_from_density(density: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """[res, res, res] max-pooled cell densities -> 0/1 cell mask."""
    return (density > threshold).to(torch.float32)


def grid_cell_positions(res: int, sub: int = 2) -> np.ndarray:
    """[res^3 * sub^3, 3] query points in the unit cube: ``sub``^3 fixed
    offsets per cell, cells row-major, offsets fastest."""
    c = np.arange(res, dtype=np.float32)
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    cells = np.stack([cx, cy, cz], -1).reshape(-1, 1, 3)
    o = (np.arange(sub, dtype=np.float32) + 0.5) / sub
    ox, oy, oz = np.meshgrid(o, o, o, indexing="ij")
    offs = np.stack([ox, oy, oz], -1).reshape(1, -1, 3)
    return ((cells + offs) / res).reshape(-1, 3).astype(np.float32)
