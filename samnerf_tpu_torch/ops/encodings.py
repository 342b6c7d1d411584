"""Input encodings: the flat multiresolution hash grid, spherical harmonics,
frequency and Fourier features, mip-NeRF's integrated encoding, the
TensoRF / triplane factorizations and the temporal hash grid.

Counterpart of ``samnerf_tpu/ops/encodings.py``.  None of these is a TPU
kernel there (they are XLA), so each is plain PyTorch here; the parity
hash grid that the Pallas kernels serve is :mod:`samnerf_tpu_torch.ops.hash_grid`.

The flat hash grid keeps the JAX package's feature-major table
``[F, L * 2^S]`` and channel order (c = f * L + l).  Corner hashes are
taken in int64 and reduced mod 2^32, which gives the JAX package's uint32
products bit for bit.  Its backward adds each corner's contribution into
the table with ``index_add_`` where JAX sorts and prefix-sums: the same
sums in another order.  Positions get no gradient in either package.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def hash_grid_scalings(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level grid resolutions (``encodings.py:252-254`` in the reference)."""
    if num_levels == 1:
        return np.array([float(min_res)])
    growth = np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
    return np.floor(min_res * growth ** np.arange(num_levels))


def init_hash_table(generator: torch.Generator, num_levels: int, table_size: int,
                    features_per_level: int, scale: float = 1e-4,
                    device="cuda") -> torch.Tensor:
    """U(-1, 1) * scale, [F, L * table_size] f32 (feature-major)."""
    shape = (features_per_level, num_levels * table_size)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((u * 2.0 - 1.0) * scale).to(device)


def _corner_indices_weights(positions: torch.Tensor, scalings,
                            log2_table_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [N, 3] -> (table columns [8, L, N] int64, level offsets
    included; trilinear weights [8, L, N] f32), corners z-major."""
    table_size = 1 << log2_table_size
    num_levels = len(scalings)
    pos_t = positions.T.float()                                   # [3, N]
    scales = torch.as_tensor(np.asarray(scalings, np.float32), device=positions.device)
    scaled = pos_t[:, None, :] * scales[None, :, None]            # [3, L, N]
    floor = torch.floor(scaled)
    offset = scaled - floor
    base = floor.long() & _U32
    primes = torch.tensor(_PRIMES, dtype=torch.long, device=positions.device)[:, None, None]
    h0 = (base * primes) & _U32
    h1 = (((base + 1) & _U32) * primes) & _U32
    level_offset = (torch.arange(num_levels, device=positions.device)
                    * table_size)[:, None]
    idxs, ws = [], []
    for cz in (0, 1):
        hz = (h1 if cz else h0)[2]
        wz = offset[2] if cz else (1.0 - offset[2])
        for cy in (0, 1):
            hzy = hz ^ (h1 if cy else h0)[1]
            wzy = wz * (offset[1] if cy else (1.0 - offset[1]))
            for cx in (0, 1):
                hx = (h1 if cx else h0)[0]
                idxs.append(((hx ^ hzy) & (table_size - 1)) + level_offset)
                ws.append(wzy * (offset[0] if cx else (1.0 - offset[0])))
    return torch.stack(idxs), torch.stack(ws)


class _FlatHashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, positions, scalings, log2_table_size):
        idx, w = _corner_indices_weights(positions, scalings, log2_table_size)
        ctx.save_for_backward(idx, w)
        ctx.table_shape = table.shape
        n = positions.shape[0]
        src = table.float()
        out = None
        for c in range(8):
            contrib = src[:, idx[c]] * w[c][None]                  # [F, L, N]
            out = contrib if out is None else out + contrib
        return out.reshape(-1, n).T

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        f_dim, num_slots = ctx.table_shape
        num_levels, n = idx.shape[1], idx.shape[2]
        g_t = g.T.reshape(f_dim, num_levels, n).float()
        u = (g_t[None] * w[:, None]).transpose(0, 1).reshape(f_dim, -1)
        grad = torch.zeros((f_dim, num_slots), dtype=torch.float32, device=g.device)
        grad.index_add_(1, idx.reshape(-1), u)
        return grad, None, None, None


def hash_encode(table: torch.Tensor, positions: torch.Tensor, scalings,
                log2_table_size: int) -> torch.Tensor:
    """Flat multiresolution hash encode: table [F, L * 2^S], positions
    [N, 3] in [0, 1] -> [N, F * L] f32 (feature-major channels).  The
    table gets its gradient; positions get none."""
    return _FlatHashEncode.apply(table, positions, tuple(scalings), log2_table_size)


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH components up to ``levels`` (16 outputs for levels=4) of
    unit directions [..., 3]."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [-0.48860251190291987 * y,
                  0.48860251190291987 * z,
                  -0.48860251190291987 * x]
    if levels > 2:
        comps += [1.0925484305920792 * x * y,
                  -1.0925484305920792 * y * z,
                  0.94617469575755997 * zz - 0.31539156525251999,
                  -1.0925484305920792 * x * z,
                  0.54627421529603959 * (xx - yy)]
    if levels > 3:
        comps += [0.59004358992664352 * y * (-3.0 * xx + yy),
                  2.8906114426405538 * x * y * z,
                  0.45704579946446572 * y * (1.0 - 5.0 * zz),
                  0.3731763325901154 * z * (5.0 * zz - 3.0),
                  0.45704579946446572 * x * (1.0 - 5.0 * zz),
                  1.4453057213202769 * z * (xx - yy),
                  0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(comps, dim=-1)


def _freqs(num_frequencies: int, like: torch.Tensor) -> torch.Tensor:
    return 2.0 ** torch.arange(num_frequencies, dtype=torch.float32, device=like.device)


def nerf_frequency_encoding(x: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    """NeRF's sin/cos encoding: [..., D] -> [..., D * 2F], per input
    dimension the F sines of pi * 2^k x, then the F cosines."""
    scaled = x[..., None] * _freqs(num_frequencies, x)
    enc = torch.cat([torch.sin(math.pi * scaled), torch.cos(math.pi * scaled)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)


def rff_encoding(x: torch.Tensor, b_matrix: torch.Tensor) -> torch.Tensor:
    """Random Fourier features: x [..., D] through a fixed B [D, F] ->
    [..., 2F] (sines, then cosines)."""
    proj = 2.0 * math.pi * (x @ b_matrix)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def integrated_pos_enc(means: torch.Tensor, covs_diag: torch.Tensor,
                       num_frequencies: int) -> torch.Tensor:
    """mip-NeRF's integrated encoding: the frequency encoding of ``means``
    [..., D] damped by exp(-var / 2) of the diagonal covariance ->
    [..., 2 * D * F]."""
    freqs = _freqs(num_frequencies, means)
    scaled = means[..., None] * freqs * math.pi
    atten = torch.exp(-0.5 * (covs_diag[..., None] * (freqs * math.pi) ** 2))
    enc = torch.cat([torch.sin(scaled) * atten, torch.cos(scaled) * atten], dim=-1)
    return enc.reshape(*means.shape[:-1], -1)


def conical_frustum_to_gaussian(ray_samples) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's conical frustum as a Gaussian (mip-NeRF eq. 7): (mean
    [R, S, 3], diagonal covariance [R, S, 3]); the cone's radius comes
    from the ray's ``pixel_area``."""
    origins = ray_samples.origins[..., None, :]
    directions = ray_samples.directions[..., None, :]
    t0, t1 = ray_samples.starts, ray_samples.ends
    radius = (torch.sqrt(ray_samples.pixel_area) / 1.7724538509055159)[..., None, :]
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = torch.clamp_min(3.0 * mu ** 2 + hw ** 2, 1e-10)
    t_mean = mu + (2.0 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * ((hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2)
    r_var = radius ** 2 * (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                           - (4.0 / 15.0) * (hw ** 4) / denom)
    mean = origins + directions * t_mean
    d2 = directions ** 2
    cov_diag = t_var * d2 + r_var * (1.0 - d2 / torch.clamp_min(
        torch.sum(d2, dim=-1, keepdim=True), 1e-10))
    return mean, cov_diag


def _interp_1d(lines: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear lookup: lines [A, RES, C], u [A, N] in [0, 1] -> [A, N, C]."""
    a, res, c = lines.shape
    x = torch.clamp(u, 0.0, 1.0) * (res - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, res - 2)
    f = (x - x0)[..., None]
    idx = x0[..., None].expand(a, x0.shape[1], c)
    g0 = torch.gather(lines, 1, idx)
    g1 = torch.gather(lines, 1, idx + 1)
    return g0 * (1.0 - f) + g1 * f


def _interp_2d(planes: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup: planes [A, RES, RES, C] (row = v), uv [A, N, 2] in
    [0, 1] -> [A, N, C]."""
    a, res, _, c = planes.shape
    xy = torch.clamp(uv, 0.0, 1.0) * (res - 1)
    xy0 = torch.clamp(torch.floor(xy).long(), 0, res - 2)
    f = xy - xy0
    flat = planes.reshape(a, res * res, c)

    def g(ix, iy):
        idx = (iy * res + ix)[..., None].expand(a, ix.shape[1], c)
        return torch.gather(flat, 1, idx)

    x0, y0 = xy0[..., 0], xy0[..., 1]
    fx, fy = f[..., 0:1], f[..., 1:2]
    return (g(x0, y0) * (1 - fx) * (1 - fy) + g(x0 + 1, y0) * fx * (1 - fy)
            + g(x0, y0 + 1) * (1 - fx) * fy + g(x0 + 1, y0 + 1) * fx * fy)


def tensor_cp_encode(lines: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """TensorCP: the product of the three axis lines' features; lines
    [3, RES, C], positions [N, 3] in [0, 1] -> [N, C]."""
    feats = _interp_1d(lines, positions.T)
    return feats[0] * feats[1] * feats[2]


def tensor_vm_encode(planes: torch.Tensor, lines: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """TensorVM: each plane (yz, xz, xy) times its complementary line (x,
    y, z), concatenated; planes [3, RES, RES, C], lines [3, RES, C] ->
    [N, 3C]."""
    p = positions
    uv = torch.stack([p[:, [1, 2]], p[:, [0, 2]], p[:, [0, 1]]])
    out = _interp_2d(planes, uv) * _interp_1d(lines, p.T)
    return torch.cat([out[0], out[1], out[2]], dim=-1)


def triplane_encode(planes: torch.Tensor, positions: torch.Tensor,
                    reduce: str = "sum") -> torch.Tensor:
    """Triplane: the xy, xz and yz planes' features, summed or multiplied;
    planes [3, RES, RES, C] -> [N, C]."""
    p = positions
    f = _interp_2d(planes, torch.stack([p[:, [0, 1]], p[:, [0, 2]], p[:, [1, 2]]]))
    if reduce == "sum":
        return f[0] + f[1] + f[2]
    if reduce == "product":
        return f[0] * f[1] * f[2]
    raise ValueError(reduce)


def temporal_hash_encode(table: torch.Tensor, positions: torch.Tensor,
                         times: torch.Tensor, scalings, log2_table_size: int,
                         num_time_steps: int) -> torch.Tensor:
    """The flat hash grid with time: positions [N, 3] encoded at the two
    time steps around ``times`` [N] in [0, 1], each shifted by step *
    0.618... so the steps address other table rows, and blended linearly
    -> [N, F*L]."""
    t = torch.clamp(times, 0.0, 1.0) * (num_time_steps - 1)
    t0 = torch.clamp(torch.floor(t).long(), 0, num_time_steps - 2)
    f = (t - t0)[:, None]

    def enc_at(ti):
        offs = (ti.float() * 0.61803398875)[:, None]
        return hash_encode(table, positions + offs, scalings, log2_table_size)

    return enc_at(t0) * (1.0 - f) + enc_at(t0 + 1) * f
