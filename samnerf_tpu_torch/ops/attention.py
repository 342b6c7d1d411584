"""Attention with SAM's decomposed relative-position bias (PyTorch + CUDA).

Counterpart of ``samnerf_tpu/ops/attention_pallas.py``: softmax over
``q k^T * scale + rel_h[q, j // Kw] + rel_w[q, j % Kw]`` for every key
``j = kh * Kw + kw`` of the token grid, without the N x N logits in device
memory.  Used by the ViT image encoder's global layers.

- :func:`reference_attention_relpos`: the plain version (materialises the
  logits); the CPU path and what the kernel is held against;
- :func:`flash_attention_relpos`: FLASH-RELPOS, the wrapper of the
  hand-written kernels in ``csrc/attention_relpos.cu`` (f32 and bf16
  operands).  CPU tensors run the plain version, CUDA tensors launch the
  kernel of their dtype (or raise); bf16 takes one of two kernels, as
  :func:`bf16_route` decides.  ``launches``, ``launches_bf16`` and
  ``launches_bf16_wgmma`` count kernel launches (registered in
  :mod:`samnerf_tpu_torch.ops.kernel_launches`);
- :func:`attention_relpos`: the wrapper under autograd, whose backward
  recomputes through a plain version, as ``_flash_bwd_rule`` does in the
  JAX package (there is no backward kernel): on f32 operands through
  :func:`reference_attention_relpos`, on bf16 ones through a mirror of
  JAX's bf16 ``reference_attention_relpos``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from samnerf_tpu_torch.ops import kernel_launches
from samnerf_tpu_torch.utils.dtypes import scalar

MAX_HEAD_DIM = 128        # the kernels pad D to 8 KD, KD <= 16 mma k-steps
MAX_REL_SUM = 256         # Kh + Kw: the first kernel's limit, kept as the contract
WGMMA_KEY_TILE = 64       # the wgmma kernel's key tile: one row of a Kw = 64 grid


def bf16_route(d: int, kw: int, aligned: bool) -> str:
    """The bf16 kernel for head dim ``d`` on a grid ``kw`` keys wide:
    ``"wgmma"`` (``flash_relpos_bf16_wgmma_kernel``: TMA tiles, so rows of
    a multiple of 16 bytes, ``d % 8 == 0``, and q, k and v 16-byte
    aligned; a key tile is one grid row, so ``kw == 64``) for SAM's global
    layers, else ``"mma_sync"`` (``flash_relpos_bf16_kernel``, any shape
    the wrapper takes)."""
    if kw == WGMMA_KEY_TILE and d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM and aligned:
        return "wgmma"
    return "mma_sync"


def reference_attention_relpos(q, k, v, rel_h, rel_w, scale: float):
    """q, k, v [B, N, D]; rel_h [B, N, Kh]; rel_w [B, N, Kw] with
    Kh * Kw == N -> [B, N, D] in ``q.dtype``.  As the Pallas kernel does,
    bf16 operands are upcast and everything is computed in f32; the
    output is rounded to ``q.dtype`` once."""
    dtype = q.dtype
    q, k, v, rel_h, rel_w = (t.float() for t in (q, k, v, rel_h, rel_w))
    logits = torch.matmul(q * scale, k.transpose(-2, -1))
    b, n, _ = q.shape
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, n, n)
    attn = torch.softmax(logits + bias, dim=-1)
    return torch.matmul(attn, v).to(dtype)


def _reference_attention_relpos_bf16(q, k, v, rel_h, rel_w, scale: float):
    """JAX's ``reference_attention_relpos`` on bf16 operands, the function
    its ``_flash_bwd_rule`` differentiates: ``q * scale`` (the scale
    rounded to bf16 first), the product with k and the bias add in bf16,
    the softmax in f32, and the attention rounded to bf16 before its
    product with v.  Used for the backward only; the forward's plain
    version stays f32 inside, as the Pallas kernel is."""
    logits = torch.matmul(q * scalar(scale, q.dtype), k.transpose(-2, -1))
    b, n, _ = q.shape
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, n, n)
    attn = torch.softmax((logits + bias).float(), dim=-1)
    return torch.matmul(attn.to(q.dtype), v)


@functools.cache
def _lib():
    from samnerf_tpu_torch.ops import cuda_build
    lib = cuda_build.load("attention_relpos")
    for fn in (lib.flash_attention_relpos_f32, lib.flash_attention_relpos_bf16,
               lib.flash_attention_relpos_bf16_wgmma):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, rel_h, rel_w):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != q.dtype or t.ndim != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-d {q.dtype} tensor (all "
                             f"five of one dtype), got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("q, k, v, rel_h and rel_w must be on one device")
    b, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if rel_h.shape[:2] != (b, n) or rel_w.shape[:2] != (b, n) or kh * kw != n:
        raise ValueError(f"rel_h {tuple(rel_h.shape)} and rel_w {tuple(rel_w.shape)} "
                         f"must be [B, N, Kh] and [B, N, Kw] with Kh * Kw == N = {n}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not supported (1 to {MAX_HEAD_DIM})")
    if kh + kw > MAX_REL_SUM:
        raise ValueError(f"Kh + Kw = {kh + kw} exceeds {MAX_REL_SUM}")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch * heads = {b} must be in 1..65535")


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """FLASH-RELPOS: q, k, v [B, N, D] (B = batch * heads), rel_h
    [B, N, Kh], rel_w [B, N, Kw] with Kh * Kw == N -> [B, N, D], all five
    float32 or all five bfloat16 (f32 inside, the output rounded once).

    Replaces ``attention_pallas.py`` ``_attn_kernel``.  CPU tensors run
    :func:`reference_attention_relpos`; CUDA tensors launch, on the
    current stream, ``flash_relpos_kernel`` (f32, counted in
    ``launches``) or a bf16 kernel (counted in ``launches_bf16``):
    ``flash_relpos_bf16_wgmma_kernel`` where :func:`bf16_route` says
    "wgmma" (also counted in ``launches_bf16_wgmma``), else
    ``flash_relpos_bf16_kernel``."""
    _check(q, k, v, rel_h, rel_w)
    if q.device.type == "cpu":
        return reference_attention_relpos(q, k, v, rel_h, rel_w, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, n, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = q.dtype == torch.bfloat16
    wgmma = bf16 and bf16_route(d, rel_w.shape[-1], all(
        t.data_ptr() % 16 == 0 for t in (q, k, v))) == "wgmma"
    lib = _lib()
    fn = (lib.flash_attention_relpos_bf16_wgmma if wgmma else
          lib.flash_attention_relpos_bf16 if bf16 else lib.flash_attention_relpos_f32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
             out.data_ptr(), b, n, d, rel_h.shape[-1], rel_w.shape[-1], float(scale),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError_t {err}")
    if bf16:
        flash_attention_relpos.launches_bf16 += 1
        flash_attention_relpos.launches_bf16_wgmma += int(wgmma)
    else:
        flash_attention_relpos.launches += 1
    return out


kernel_launches.register("FLASH-RELPOS", flash_attention_relpos, ("flash_relpos_kernel",))
kernel_launches.register("FLASH-RELPOS-BF16", flash_attention_relpos,
                         ("flash_relpos_bf16_kernel", "flash_relpos_bf16_wgmma_kernel"),
                         attr="launches_bf16")
kernel_launches.register("FLASH-RELPOS-BF16-WGMMA", flash_attention_relpos,
                         ("flash_relpos_bf16_wgmma_kernel",), attr="launches_bf16_wgmma")


class _AttentionRelPos(torch.autograd.Function):
    """FLASH-RELPOS forward; the backward is autograd through a plain
    version on the saved inputs (``attention_pallas._flash_bwd_rule``):
    the f32 one, or on bf16 operands JAX's bf16 reference."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale = scale
        return flash_attention_relpos(q, k, v, rel_h, rel_w, scale)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        plain = (_reference_attention_relpos_bf16 if inputs[0].dtype == torch.bfloat16
                 else reference_attention_relpos)
        with torch.enable_grad():
            out = plain(*inputs, ctx.scale)
        grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None)


def attention_relpos(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """:func:`flash_attention_relpos` with gradients for all five tensors."""
    return _AttentionRelPos.apply(q, k, v, rel_h, rel_w, scale)
