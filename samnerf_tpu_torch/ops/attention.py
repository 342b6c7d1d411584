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
  kernel of their dtype (or raise); ``launches`` and ``launches_bf16``
  count kernel launches;
- :func:`attention_relpos`: the wrapper under autograd, whose backward
  recomputes through the plain version, as ``_flash_bwd_rule`` does in the
  JAX package (there is no backward kernel).
"""
from __future__ import annotations

import ctypes
import functools

import torch

MAX_HEAD_DIM = 128        # the kernel pads D to 8 KD, KD <= 16 mma k-steps
MAX_REL_SUM = 256         # Kh + Kw: the first kernel's limit, kept as the contract


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


@functools.cache
def _lib():
    from samnerf_tpu_torch.ops import cuda_build
    lib = cuda_build.load("attention_relpos")
    for fn in (lib.flash_attention_relpos_f32, lib.flash_attention_relpos_bf16):
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
    :func:`reference_attention_relpos`; CUDA tensors launch
    ``flash_relpos_kernel`` (f32, counted in ``launches``) or
    ``flash_relpos_bf16_kernel`` (bf16, counted in ``launches_bf16``) on
    the current stream."""
    _check(q, k, v, rel_h, rel_w)
    if q.device.type == "cpu":
        return reference_attention_relpos(q, k, v, rel_h, rel_w, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, n, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = q.dtype == torch.bfloat16
    lib = _lib()
    fn = lib.flash_attention_relpos_bf16 if bf16 else lib.flash_attention_relpos_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
             out.data_ptr(), b, n, d, rel_h.shape[-1], rel_w.shape[-1], float(scale),
             ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError_t {err}")
    if bf16:
        flash_attention_relpos.launches_bf16 += 1
    else:
        flash_attention_relpos.launches += 1
    return out


flash_attention_relpos.launches = 0
flash_attention_relpos.launches_bf16 = 0


class _AttentionRelPos(torch.autograd.Function):
    """FLASH-RELPOS forward; the backward is autograd through the plain
    version on the saved inputs (``attention_pallas._flash_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale):
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.scale = scale
        return flash_attention_relpos(q, k, v, rel_h, rel_w, scale)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = reference_attention_relpos(*inputs, ctx.scale)
        grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None)


def attention_relpos(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """:func:`flash_attention_relpos` with gradients for all five tensors."""
    return _AttentionRelPos.apply(q, k, v, rel_h, rel_w, scale)
