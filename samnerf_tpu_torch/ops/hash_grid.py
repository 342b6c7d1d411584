"""Parity-partitioned multiresolution hash encode (PyTorch + CUDA).

Counterpart of ``samnerf_tpu/ops/hash_pallas.py``.  The table layout,
index math, bf16 rounding of table reads and the int8/int4 packing are the
JAX package's, bit for bit: they are also the checkpoint format.

- table ``[P*L, steps*8, 128, 2]`` f32 master pairs; row ``8*hi+s`` holds
  parity class ``s``; positions ``[N, 3]`` in [0, 1] -> ``[N, P*2*L]`` f32,
  channel ``(p*2+f)*L+l``.
- dense coarse levels index linearly with ``half = res//2+2``; finer levels
  hash with the primes-XOR hash, optionally remixed by ``_morton_mix``
  (``hash_fn="morton[N]"``).

Four kernels (``csrc/hash_encode.cu``): :func:`parity_hash_encode`
(F32-ENC) and :func:`parity_hash_encode_q8` (Q-ENC, qbits 8 or 4) carry
the serve path, and :func:`parity_hash_encode_qmlp` (FUSED-QMLP) fuses
Q-ENC with the MLP after it when the model serves with
``serve_fuse_mlp``; :func:`hash_encode` binds F32-ENC and its table
gradient :func:`parity_hash_encode_bwd` (F32-ENC-BWD) into autograd for
training.  Q-ENC and FUSED-QMLP read the packed tables in the serve
layout of :func:`interleave_packs`, ``[L, rows_q, 128, P]``, where the P
packs of one (level, row, lane) sit side by side; the packed
``[P*L, rows_q, 128]`` stays the checkpoint format.  Each wrapper runs
its plain PyTorch version
(:func:`parity_hash_encode_ref`, :func:`_parity_hash_encode_q8_ref`,
:func:`_parity_hash_encode_qmlp_ref`, :func:`parity_hash_encode_bwd_ref`)
for CPU tensors and launches the kernel for CUDA tensors; ``launches`` on
the wrapper counts kernel launches.  The TPU's slab scans, touched-slab
ids, group skips and point sorting have no counterpart: on Hopper each
corner is a direct gather and each gradient contribution an atomic add.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import numpy as np
import torch

LANES = 128
PARITIES = 8
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def level_is_dense(res: int, num_steps: int) -> bool:
    """A parity class holds ceil((res+2)/2)^3 lattice points when indexed
    densely; dense iff that fits the class capacity (num_steps * 128)."""
    half = res // 2 + 2
    return half ** 3 <= num_steps * LANES


def _level_plan(scalings: Sequence[float], num_steps: int):
    """Static per-level plan: (resolution scale, dense?, half grid size)."""
    plan = []
    for s in scalings:
        res = int(np.floor(float(s)))
        plan.append((float(s), level_is_dense(res, num_steps), res // 2 + 2))
    return tuple(plan)


def morton_key_width(hash_fn: str) -> int:
    """Spatial key width of a "morton[N]" hash_fn string (default 4)."""
    if hash_fn.startswith("morton") and hash_fn[6:]:
        return int(hash_fn[6:])
    return 4


def _morton_inv(scale: float) -> float:
    """``1 / max(scale, 1)`` rounded as the reference computes it, in f32."""
    return float(np.float32(1.0) / np.maximum(np.float32(scale),
                                              np.float32(1.0)))


def _morton_mix(idx_hash, cx, cy, cz, scale, num_steps, key_bits: int = 4):
    """Locality-preserving remix (``hash_pallas.py:156-182``): the top
    ``key_bits`` index bits become a coarse spatial key, in f32 and in the
    reference's order of operations.  ``idx_hash`` is int64 holding a
    uint32."""
    bits = int(math.log2(num_steps * LANES))
    inv = _morton_inv(scale)
    axes = (cx.to(torch.float32) * inv, cy.to(torch.float32) * inv,
            cz.to(torch.float32) * inv)
    key = torch.zeros_like(idx_hash)
    for b in range(key_bits):
        v = axes[b % 3] * float(1 << (b // 3))
        key = (key << 1) | ((v - torch.floor(v)) >= 0.5).to(torch.int64)
    low = bits - key_bits
    return ((key << low) | (idx_hash & ((1 << low) - 1))) & _U32


def _corner_index_math(x, y, z, scale, dense, half, num_steps, s0, s1, s2,
                       hash_fn: str = "reference"):
    """Index math of ``hash_pallas.py:104-146``: (1, N) coords and (8, 1)
    parity bits -> lo, hi (int64) and trilinear weights w, each [8, N].
    The uint32 arithmetic runs in int64 masked to 32 bits."""
    sx, sy, sz = x * scale, y * scale, z * scale
    fx, fy, fz = torch.floor(sx), torch.floor(sy), torch.floor(sz)
    ox, oy, oz = sx - fx, sy - fy, sz - fz
    ix, iy, iz = fx.to(torch.int64), fy.to(torch.int64), fz.to(torch.int64)
    ex, ey, ez = (ix & 1) ^ s0, (iy & 1) ^ s1, (iz & 1) ^ s2
    cx, cy, cz = ix + ex, iy + ey, iz + ez
    w = (torch.where(ex == 1, ox, 1.0 - ox)
         * torch.where(ey == 1, oy, 1.0 - oy)
         * torch.where(ez == 1, oz, 1.0 - oz))
    if dense:
        idx = ((cx >> 1) + half * ((cy >> 1) + half * (cz >> 1))) & _U32
    else:
        idx = (((cx * _PRIMES[0]) & _U32) ^ ((cy * _PRIMES[1]) & _U32)
               ^ ((cz * _PRIMES[2]) & _U32))
        if hash_fn.startswith("morton"):
            idx = _morton_mix(idx, cx, cy, cz, scale, num_steps,
                              morton_key_width(hash_fn))
    lo = idx & (LANES - 1)
    hi = (idx >> 7) & (num_steps - 1)
    return lo, hi, w


def _parity_bits(device):
    s = torch.arange(PARITIES, device=device)[:, None]
    return s, s & 1, (s >> 1) & 1, (s >> 2) & 1


def parity_hash_encode_ref(table: torch.Tensor, positions: torch.Tensor,
                           scalings, num_steps: int,
                           hash_fn: str = "reference") -> torch.Tensor:
    """Plain version of F32-ENC (``hash_pallas.py:1711-1736``): table
    [P*L, steps*8, 128, 2] f32 read at bf16 precision, positions [N, 3] in
    [0, 1] -> [N, P*2*L]."""
    plan = _level_plan(scalings, num_steps)
    num_levels = len(plan)
    num_packed = table.shape[0] // num_levels
    tq = table.to(torch.bfloat16).to(torch.float32)
    x, y, z = positions[:, 0][None], positions[:, 1][None], positions[:, 2][None]
    s, s0, s1, s2 = _parity_bits(positions.device)
    per_level = []
    for scale, dense, half in plan:
        lo, hi, w = _corner_index_math(x, y, z, scale, dense, half,
                                       num_steps, s0, s1, s2, hash_fn)
        per_level.append((hi * PARITIES + s, lo, w))
    outs = []
    for p in range(num_packed):
        for f in range(2):
            for l in range(num_levels):
                row, lo, w = per_level[l]
                vals = tq[p * num_levels + l, row, lo, f]       # [8, N]
                outs.append(torch.sum(vals * w, dim=0))
    return torch.stack(outs, dim=-1)


def parity_hash_encode_bwd_ref(grad_out: torch.Tensor, positions: torch.Tensor,
                               scalings, num_steps: int,
                               hash_fn: str = "reference") -> torch.Tensor:
    """Plain version of F32-ENC-BWD: the vjp of
    :func:`parity_hash_encode_ref` with respect to the table, taken at a
    zero table as ``hash_pallas.py:1900-1906`` takes it.  Autograd through
    the bf16 read rounds the accumulated gradient to bf16, as JAX's CPU
    vjp does.  grad_out [N, P*2*L] -> [P*L, steps*8, 128, 2]."""
    shape = (grad_out.shape[1] // 2, num_steps * PARITIES, LANES, 2)
    with torch.enable_grad():
        table = torch.zeros(shape, device=positions.device, requires_grad=True)
        out = parity_hash_encode_ref(table, positions, scalings, num_steps,
                                     hash_fn)
        (grad,) = torch.autograd.grad(out, table, grad_out)
    return grad


def _parity_hash_encode_q8_ref(packed_q8: torch.Tensor, scales: torch.Tensor,
                               positions: torch.Tensor, scalings,
                               num_steps: int, hash_fn: str = "reference",
                               qbits: int = 8) -> torch.Tensor:
    """Plain version of Q-ENC (``hash_pallas.py:1445-1480``): unpack the
    byte or nibble of class entry ``e = hi*128+lo``, sign-extend, scale,
    same corner math."""
    plan = _level_plan(scalings, num_steps)
    num_levels = len(plan)
    num_packed = packed_q8.shape[0] // num_levels
    words = packed_q8.view(torch.int32).to(torch.int64) & _U32
    x, y, z = positions[:, 0][None], positions[:, 1][None], positions[:, 2][None]
    s, s0, s1, s2 = _parity_bits(positions.device)
    per_level = []
    for scale, dense, half in plan:
        lo, hi, w = _corner_index_math(x, y, z, scale, dense, half,
                                       num_steps, s0, s1, s2, hash_fn)
        e = (hi << 7) | lo
        if qbits == 8:
            row, lane, shift = (e >> 8) * PARITIES + s, (e >> 1) & 127, 16 * (e & 1)
        else:
            row, lane, shift = (e >> 9) * PARITIES + s, (e >> 2) & 127, 8 * (e & 3)
        per_level.append((row, lane, shift, w))
    bits, mask = (8, 0xFF) if qbits == 8 else (4, 0xF)
    sign = 1 << (bits - 1)
    outs = []
    for p in range(num_packed):
        for f in range(2):
            for l in range(num_levels):
                row, lane, shift, w = per_level[l]
                word = words[p * num_levels + l, row, lane]
                v = (word >> (shift + bits * f)) & mask
                val = ((v ^ sign) - sign).to(torch.float32) \
                    * scales[p * num_levels + l]
                outs.append(torch.sum(val * w, dim=0))
    return torch.stack(outs, dim=-1)


def _parity_hash_encode_qmlp_ref(packed_list, scales_list, positions,
                                 scalings_list, num_steps: int, w1, b1, w2, b2,
                                 hash_fn: str = "reference",
                                 qbits: int = 8) -> torch.Tensor:
    """Plain version of FUSED-QMLP (``hash_pallas.py:1620-1626``): Q-ENC's
    plain version per pyramid, concatenated pyramid-major, then the f32
    MLP ``relu(enc @ w1 + b1) @ w2 + b2``."""
    enc = torch.cat([_parity_hash_encode_q8_ref(pk, sc, positions, s, num_steps,
                                                hash_fn, qbits)
                     for pk, sc, s in zip(packed_list, scales_list, scalings_list)],
                    dim=-1)
    return torch.relu(enc @ w1 + b1) @ w2 + b2


# --- int8 / int4 serve tables --------------------------------------------------


def optimal_quant_scales(table: torch.Tensor, qbits: int = 8,
                         num_candidates: int = 12) -> torch.Tensor:
    """MSE-optimal symmetric scale per (pack, level) row
    (``hash_pallas.py:1063-1085``): the best of ``num_candidates`` clip
    fractions of the max scale, searched one candidate at a time."""
    qmax = 127 if qbits == 8 else 7
    base = torch.clamp_min(torch.amax(table.abs(), dim=(1, 2, 3)), 1e-12) / qmax
    fracs = torch.linspace(1.0 / num_candidates, 1.0, num_candidates,
                           device=table.device)
    errs = []
    for frac in fracs:
        sc = (base * frac)[:, None, None, None]
        q = torch.clamp(torch.round(table / sc), -qmax, qmax)
        errs.append(torch.sum((q * sc - table) ** 2, dim=(1, 2, 3)))
    return base * fracs[torch.argmin(torch.stack(errs), dim=0)]


def quantize_parity_table(table: torch.Tensor, qbits: int = 8, scales=None):
    """[PL, steps*8, 128, 2] f32 master -> (packed [PL, ceil(steps/E)*8,
    128] f32 holding uint32 bits, scales [PL] f32), E = 2 entries per word
    at qbits 8 and 4 at qbits 4 (``hash_pallas.py:1088-1134``)."""
    if qbits not in (8, 4):
        raise ValueError(f"qbits must be 8 or 4, got {qbits}")
    pl_rows, rows = table.shape[:2]
    steps = rows // PARITIES
    epl = 2 if qbits == 8 else 4
    steps_q = max(-(-steps // epl), 1)
    qmax = 127 if qbits == 8 else 7
    if scales is None:
        scales = torch.clamp_min(torch.amax(table.abs(), dim=(1, 2, 3)),
                                 1e-12) / qmax
    q = torch.clamp(torch.round(table / scales[:, None, None, None]),
                    -qmax, qmax).to(torch.int64)
    # rows (8t+s) -> class-entry order e = t*128 + lane
    q = q.reshape(pl_rows, steps, PARITIES, LANES, 2).transpose(1, 2)
    q = q.reshape(pl_rows, PARITIES, steps * LANES, 2)
    pad = steps_q * epl * LANES - steps * LANES
    if pad:
        q = torch.cat([q, q.new_zeros((pl_rows, PARITIES, pad, 2))], dim=2)
    if qbits == 8:
        # [PL, 8, tq, lane, half, f]; e = tq*256 + lane*2 + half
        b = q.reshape(pl_rows, PARITIES, steps_q, LANES, 2, 2) & 0xFF
        u32 = (b[..., 0, 0] | (b[..., 0, 1] << 8)
               | (b[..., 1, 0] << 16) | (b[..., 1, 1] << 24))
    else:
        # [PL, 8, tq, lane, quarter, f]; e = tq*512 + lane*4 + quarter
        nib = q.reshape(pl_rows, PARITIES, steps_q, LANES, 4, 2) & 0xF
        byte = nib[..., 0] | (nib[..., 1] << 4)
        u32 = (byte[..., 0] | (byte[..., 1] << 8)
               | (byte[..., 2] << 16) | (byte[..., 3] << 24))
    u32 = u32.transpose(1, 2).reshape(pl_rows, steps_q * PARITIES, LANES)
    i32 = torch.where(u32 >= 1 << 31, u32 - (1 << 32), u32).to(torch.int32)
    return i32.view(torch.float32), scales


def interleave_packs(packed: torch.Tensor, num_levels: int) -> torch.Tensor:
    """The serve layout of a packed table: [P*L, rows_q, 128] (row
    ``p*L + l``) -> [L, rows_q, 128, P], a fresh contiguous tensor whose P
    words of one (level, row, lane) are adjacent, so Q-ENC and FUSED-QMLP
    gather all packs of a corner in one 4-, 8- or 16-byte load.  An exact
    permutation of the bits; P in {1, 2, 4} (2, 4 or 8 features per
    level).  At P = 1 it shares the storage."""
    if packed.ndim != 3 or packed.shape[0] % num_levels:
        raise ValueError(f"packed table must be [P*L, rows_q, 128] with L = "
                         f"{num_levels}, got {tuple(packed.shape)}")
    num_packed = packed.shape[0] // num_levels
    if num_packed not in (1, 2, 4):
        raise ValueError(f"the serve layout takes 1, 2 or 4 packs, got {num_packed}")
    words = packed.view(torch.int32).reshape(num_packed, num_levels, *packed.shape[1:])
    return words.permute(1, 2, 3, 0).contiguous().view(torch.float32)


def deinterleave_packs(table: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`interleave_packs`: [L, rows_q, 128, P] ->
    [P*L, rows_q, 128], exact."""
    num_levels, rows, lanes, num_packed = table.shape
    words = table.view(torch.int32).permute(3, 0, 1, 2)
    return words.reshape(num_packed * num_levels, rows, lanes).contiguous().view(
        torch.float32)


def is_parity_table(leaf) -> bool:
    """True for a master table leaf ([PL, steps*8, 128, 2] f32)."""
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 4
            and leaf.shape[-1] == 2 and leaf.shape[-2] == LANES
            and leaf.shape[-3] % PARITIES == 0)


def bake_quantized_tables(params, qbits=(8, 4), optimize: int = 12):
    """Add ``qtable{b}`` / ``qscales{b}`` beside every master ``table`` of
    a nested dict of tensors (``hash_pallas.py:1145-1177``).  ``optimize``
    is the number of clip-fraction candidates of the MSE-optimal scale
    search; 0 keeps the max scale, which equals the on-the-fly
    quantization bit for bit.  Returns a new dict; masters are kept."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        t = node.get("table")
        if t is not None and is_parity_table(t):
            for b in qbits:
                sc = (optimal_quant_scales(t, qbits=b, num_candidates=optimize)
                      if optimize else None)
                out[f"qtable{b}"], out[f"qscales{b}"] = quantize_parity_table(
                    t, qbits=b, scales=sc)
        return out
    return walk(params)


def init_parity_table(generator: torch.Generator, num_levels: int,
                      num_steps: int, num_packed: int = 1, scale: float = 1e-4,
                      device="cuda") -> torch.Tensor:
    """Uniform(-scale, scale) master table (``hash_pallas.py:1947``)."""
    shape = (num_packed * num_levels, num_steps * PARITIES, LANES, 2)
    u = torch.rand(shape, generator=generator, device=device)
    return (u * 2.0 - 1.0) * scale


# --- the four Hopper kernels -------------------------------------------------------


def _plan_arrays(plan, num_steps: int, hash_fn: str):
    """Per-level host arrays for the kernels' parameter block."""
    scale = np.asarray([s for s, _, _ in plan], np.float32)
    inv = np.asarray([_morton_inv(s) for s, _, _ in plan], np.float32)
    dense = np.asarray([1 if d else 0 for _, d, _ in plan], np.int32)
    half = np.asarray([h for _, _, h in plan], np.int32)
    key_bits = morton_key_width(hash_fn) if hash_fn.startswith("morton") else 0
    table_bits = int(math.log2(num_steps * LANES))
    return scale, inv, dense, half, key_bits, table_bits


def _check_common(positions: torch.Tensor, scalings, num_steps: int,
                  hash_fn: str):
    if positions.dtype != torch.float32 or positions.ndim != 2 \
            or positions.shape[1] != 3 or not positions.is_contiguous():
        raise ValueError("positions must be a contiguous [N, 3] float32 "
                         f"tensor, got {positions.dtype} {tuple(positions.shape)}")
    if num_steps < 1 or num_steps & (num_steps - 1):
        raise ValueError(f"num_steps must be a power of two, got {num_steps}")
    if hash_fn != "reference" and not hash_fn.startswith("morton"):
        raise ValueError(f"unknown hash_fn {hash_fn!r}")
    if not 1 <= len(scalings) <= 32:
        raise ValueError("the kernels take 1 to 32 levels")


def _check_serve_table(table: torch.Tensor, scales: torch.Tensor,
                  positions: torch.Tensor, num_levels: int, num_steps: int,
                  qbits: int) -> int:
    """Check one pyramid's serve table ([L, rows_q, 128, P] from
    :func:`interleave_packs`) against ``num_levels``, ``num_steps`` and
    ``qbits``; returns its rows per level."""
    if qbits not in (8, 4):
        raise ValueError(f"qbits must be 8 or 4, got {qbits}")
    epl = 2 if qbits == 8 else 4
    rows_q = max(-(-num_steps // epl), 1) * PARITIES
    if table.dtype != torch.float32 or table.ndim != 4 \
            or table.shape[:3] != (num_levels, rows_q, LANES) \
            or not table.is_contiguous():
        raise ValueError(f"serve table must be a contiguous [{num_levels}, {rows_q}, "
                         "128, P] float32 tensor (interleave_packs), got "
                         f"{table.dtype} {tuple(table.shape)}")
    num_packed = table.shape[3]
    if num_packed not in (1, 2, 4):
        raise ValueError(f"the kernels take 1, 2 or 4 packs, got {num_packed}")
    if table.data_ptr() % (4 * num_packed):
        raise ValueError("serve table must be aligned to its packs' words "
                         "(a fresh tensor, not an offset view)")
    if scales.dtype != torch.float32 \
            or scales.shape != (num_packed * num_levels,) or not scales.is_contiguous():
        raise ValueError("scales must be a contiguous [P*L] float32 tensor")
    if not (positions.device == table.device == scales.device):
        raise ValueError("serve table, scales and positions must be on one device")
    return rows_q


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"hash encode kernel launch failed: cudaError_t {err}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _np_ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


_F32_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                 + [ctypes.c_void_p] * 5)
_Q_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7
               + [ctypes.c_void_p] * 5)
_QMLP_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])


@functools.cache
def _lib():
    from samnerf_tpu_torch.ops import cuda_build
    lib = cuda_build.load("hash_encode")
    lib.parity_hash_encode_f32.argtypes = _F32_ARGTYPES
    lib.parity_hash_encode_f32.restype = ctypes.c_int
    lib.parity_hash_encode_q.argtypes = _Q_ARGTYPES
    lib.parity_hash_encode_q.restype = ctypes.c_int
    lib.parity_hash_encode_f32_bwd.argtypes = _F32_ARGTYPES
    lib.parity_hash_encode_f32_bwd.restype = ctypes.c_int
    lib.parity_hash_encode_qmlp.argtypes = _QMLP_ARGTYPES
    lib.parity_hash_encode_qmlp.restype = ctypes.c_int
    return lib


def parity_hash_encode(table: torch.Tensor, positions: torch.Tensor,
                       scalings, num_steps: int,
                       hash_fn: str = "reference") -> torch.Tensor:
    """F32-ENC: table [P*L, steps*8, 128, 2] f32 (read at bf16),
    positions [N, 3] in [0, 1] -> [N, P*2*L] f32.

    Replaces ``hash_pallas.py`` ``_fwd_kernel`` / ``_fwd_kernel_v2`` /
    ``_fwd_kernel_v4`` (one function, three TPU schedules).  CPU tensors
    run :func:`parity_hash_encode_ref`; CUDA tensors launch
    ``f32_encode_kernel`` on the current stream."""
    _check_common(positions, scalings, num_steps, hash_fn)
    num_levels = len(scalings)
    if table.dtype != torch.float32 or table.ndim != 4 \
            or table.shape[0] % num_levels or table.shape[1] != num_steps * PARITIES \
            or table.shape[2:] != (LANES, 2) or not table.is_contiguous():
        raise ValueError("table must be a contiguous [P*L, steps*8, 128, 2] "
                         f"float32 tensor, got {table.dtype} {tuple(table.shape)}")
    if positions.device != table.device:
        raise ValueError("table and positions must be on one device")
    if positions.device.type == "cpu":
        return parity_hash_encode_ref(table, positions, scalings, num_steps,
                                      hash_fn)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    plan = _level_plan(scalings, num_steps)
    scale, inv, dense, half, key_bits, table_bits = _plan_arrays(
        plan, num_steps, hash_fn)
    num_packed = table.shape[0] // num_levels
    n = positions.shape[0]
    out = torch.empty((n, num_packed * 2 * num_levels), dtype=torch.float32,
                      device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    _launch(_lib().parity_hash_encode_f32, _ptr(table), _ptr(positions),
            _ptr(out), n, num_levels, num_packed, num_steps, table_bits,
            key_bits, _np_ptr(scale), _np_ptr(inv), _np_ptr(dense),
            _np_ptr(half), ctypes.c_void_p(stream))
    parity_hash_encode.launches += 1
    return out


parity_hash_encode.launches = 0


def parity_hash_encode_q8(table: torch.Tensor, scales: torch.Tensor,
                          positions: torch.Tensor, scalings, num_steps: int,
                          hash_fn: str = "reference",
                          qbits: int = 8) -> torch.Tensor:
    """Q-ENC: serve table [L, ceil(steps/E)*8, 128, P] (uint32 bits held in
    f32: :func:`interleave_packs` of :func:`quantize_parity_table` at the
    same ``qbits``), scales [P*L] f32, positions [N, 3] -> [N, P*2*L] f32.

    Replaces ``hash_pallas.py`` ``_fwd_kernel_q8`` (qbits 8 and 4) and
    ``_fwd_kernel_q8v4``.  CPU tensors run
    :func:`_parity_hash_encode_q8_ref` on the de-interleaved table; CUDA
    tensors launch ``q_encode_kernel<qbits, P>`` on the current stream."""
    _check_common(positions, scalings, num_steps, hash_fn)
    num_levels = len(scalings)
    rows_q = _check_serve_table(table, scales, positions, num_levels, num_steps, qbits)
    if positions.device.type == "cpu":
        return _parity_hash_encode_q8_ref(deinterleave_packs(table), scales, positions,
                                          scalings, num_steps, hash_fn, qbits)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    plan = _level_plan(scalings, num_steps)
    scale, inv, dense, half, key_bits, table_bits = _plan_arrays(
        plan, num_steps, hash_fn)
    num_packed = table.shape[3]
    n = positions.shape[0]
    out = torch.empty((n, num_packed * 2 * num_levels), dtype=torch.float32,
                      device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    _launch(_lib().parity_hash_encode_q, _ptr(table), _ptr(scales),
            _ptr(positions), _ptr(out), n, num_levels, num_packed, num_steps,
            table_bits, key_bits, rows_q, qbits, _np_ptr(scale), _np_ptr(inv),
            _np_ptr(dense), _np_ptr(half), ctypes.c_void_p(stream))
    parity_hash_encode_q8.launches += 1
    return out


parity_hash_encode_q8.launches = 0

_MAX_PYRAMIDS = 4
_MAX_QMLP_OUT = 256


def parity_hash_encode_qmlp(tables, scales_list, positions: torch.Tensor,
                            scalings_list, num_steps: int, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                            hash_fn: str = "reference",
                            qbits: int = 8) -> torch.Tensor:
    """FUSED-QMLP: ``relu(enc @ w1 + b1) @ w2 + b2`` -> [N, O] f32, where
    ``enc`` [N, C] concatenates pyramid-major the Q-ENC encodes of the
    (serve table, scales, scalings) pyramids, which share ``num_steps``
    and ``qbits``; serve tables as :func:`parity_hash_encode_q8` takes
    them.  Weights in the JAX layout: w1 [C, H], b1 [H], w2 [H, O], b2
    [O], f32, O <= 256.  Serve only: no gradient.

    Replaces ``hash_pallas.py`` ``_fwd_kernel_qmlp`` (qbits 8 and 4).  CPU
    tensors run :func:`_parity_hash_encode_qmlp_ref` on the de-interleaved
    tables; CUDA tensors launch ``qmlp_kernel`` on the current stream."""
    if not (len(tables) == len(scales_list) == len(scalings_list)) \
            or not 1 <= len(tables) <= _MAX_PYRAMIDS:
        raise ValueError(f"1 to {_MAX_PYRAMIDS} pyramids, each with serve "
                         "table, scales and scalings")
    channels = 0
    for tb, sc, s in zip(tables, scales_list, scalings_list):
        _check_common(positions, s, num_steps, hash_fn)
        _check_serve_table(tb, sc, positions, len(s), num_steps, qbits)
        channels += 2 * tb.shape[0] * tb.shape[3]
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != positions.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on the "
                             f"positions' device, got {t.dtype} on {t.device}")
    if w1.ndim != 2 or w2.ndim != 2 or w1.shape[0] != channels \
            or b1.shape != (w1.shape[1],) or w2.shape[0] != w1.shape[1] \
            or b2.shape != (w2.shape[1],):
        raise ValueError(f"MLP shapes do not chain from {channels} channels: w1 "
                         f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    h_dim, o_dim = w1.shape[1], w2.shape[1]
    if o_dim > _MAX_QMLP_OUT:
        raise ValueError(f"FUSED-QMLP takes at most {_MAX_QMLP_OUT} outputs, got {o_dim}")
    if positions.device.type == "cpu":
        return _parity_hash_encode_qmlp_ref([deinterleave_packs(t) for t in tables],
                                            scales_list, positions, scalings_list,
                                            num_steps, w1, b1, w2, b2, hash_fn, qbits)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    plans = [_plan_arrays(_level_plan(s, num_steps), num_steps, hash_fn)
             for s in scalings_list]
    scale, inv, dense, half = (np.ascontiguousarray(np.concatenate([p[i] for p in plans]))
                               for i in range(4))
    key_bits, table_bits = plans[0][4], plans[0][5]
    k = len(tables)
    num_levels = np.asarray([t.shape[0] for t in tables], np.int32)
    num_packed = np.asarray([t.shape[3] for t in tables], np.int32)
    table_ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables])
    scale_ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in scales_list])
    n = positions.shape[0]
    out = torch.empty((n, o_dim), dtype=torch.float32, device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    _launch(_lib().parity_hash_encode_qmlp, k, ctypes.cast(table_ptrs, ctypes.c_void_p),
            ctypes.cast(scale_ptrs, ctypes.c_void_p), _np_ptr(num_levels),
            _np_ptr(num_packed), _np_ptr(scale), _np_ptr(inv), _np_ptr(dense),
            _np_ptr(half), _ptr(positions), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2),
            _ptr(out), n, num_steps, table_bits, key_bits,
            tables[0].shape[1], qbits, h_dim, o_dim, ctypes.c_void_p(stream))
    parity_hash_encode_qmlp.launches += 1
    return out


parity_hash_encode_qmlp.launches = 0


def parity_hash_encode_bwd(grad_out: torch.Tensor, positions: torch.Tensor,
                           scalings, num_steps: int,
                           hash_fn: str = "reference") -> torch.Tensor:
    """F32-ENC-BWD: the table gradient of :func:`parity_hash_encode`.
    grad_out [N, P*2*L] f32, positions [N, 3] -> [P*L, steps*8, 128, 2]
    f32; positions get no gradient (``hash_pallas.py:1893-1941``).

    Replaces ``hash_pallas.py`` ``_bwd_kernel`` / ``_bwd_kernel_v2`` /
    ``_bwd_kernel_v4``.  CPU tensors run :func:`parity_hash_encode_bwd_ref`;
    CUDA tensors launch ``f32_encode_bwd_kernel`` on the current stream,
    which sums in f32 with atomics (no bf16 rounding, run-to-run order)."""
    _check_common(positions, scalings, num_steps, hash_fn)
    num_levels = len(scalings)
    if grad_out.dtype != torch.float32 or grad_out.ndim != 2 \
            or grad_out.shape[0] != positions.shape[0] \
            or grad_out.shape[1] % (2 * num_levels) or not grad_out.is_contiguous():
        raise ValueError("grad_out must be a contiguous [N, P*2*L] float32 tensor, "
                         f"got {grad_out.dtype} {tuple(grad_out.shape)}")
    num_packed = grad_out.shape[1] // (2 * num_levels)
    if positions.device != grad_out.device:
        raise ValueError("grad_out and positions must be on one device")
    if positions.device.type == "cpu":
        return parity_hash_encode_bwd_ref(grad_out, positions, scalings,
                                          num_steps, hash_fn)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    plan = _level_plan(scalings, num_steps)
    scale, inv, dense, half, key_bits, table_bits = _plan_arrays(
        plan, num_steps, hash_fn)
    grad = torch.zeros((num_packed * num_levels, num_steps * PARITIES, LANES, 2),
                       dtype=torch.float32, device=positions.device)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    _launch(_lib().parity_hash_encode_f32_bwd, _ptr(positions), _ptr(grad_out),
            _ptr(grad), positions.shape[0], num_levels, num_packed, num_steps,
            table_bits, key_bits, _np_ptr(scale), _np_ptr(inv), _np_ptr(dense),
            _np_ptr(half), ctypes.c_void_p(stream))
    parity_hash_encode_bwd.launches += 1
    return grad


parity_hash_encode_bwd.launches = 0


class _HashEncode(torch.autograd.Function):
    """F32-ENC forward, F32-ENC-BWD backward (the ``jax.custom_vjp`` of
    ``hash_pallas.parity_hash_encode``).  Positions get no gradient."""

    @staticmethod
    def forward(ctx, table, positions, scalings, num_steps, hash_fn):
        ctx.save_for_backward(positions)
        ctx.plan = (scalings, num_steps, hash_fn)
        return parity_hash_encode(table, positions, scalings, num_steps, hash_fn)

    @staticmethod
    def backward(ctx, grad_out):
        (positions,) = ctx.saved_tensors
        grad = parity_hash_encode_bwd(grad_out.contiguous(), positions, *ctx.plan)
        return grad, None, None, None, None


def hash_encode(table: torch.Tensor, positions: torch.Tensor, scalings,
                num_steps: int, hash_fn: str = "reference") -> torch.Tensor:
    """:func:`parity_hash_encode` with the table gradient of
    :func:`parity_hash_encode_bwd` under autograd."""
    return _HashEncode.apply(table, positions, scalings, num_steps, hash_fn)
