"""The backward of the port's ``attention_relpos`` against JAX's
``flash_attention_relpos`` custom vjp (``_flash_bwd_rule``) on the CPU.

JAX differentiates its plain ``reference_attention_relpos`` in the
operands' own dtype.  On bf16 operands that is a bf16 computation: ``q *
scale`` with the scale rounded to bf16, a bf16 product with k, a bf16 bias
add, an f32 softmax, and the attention rounded to bf16 before a bf16
product with v.  The port's bf16 backward differentiates a mirror of that
function; its f32 backward differentiates the f32 plain version, as JAX
does in f32.  The Pallas forward runs in interpret mode.

The rel-pos gradients are sums of the bias cotangent over a grid axis.
XLA on the CPU takes that sum in bf16, one term after another; the port
sums in f32 and rounds once, as it does for every bf16 bias gradient
(``tests/test_torch_bf16_model.py``).  So the test takes JAX's own bias
cotangent (the vjp of JAX's reference with the bias as an operand), checks
that JAX's rel-pos gradients are its sequential bf16 sums, and holds the
port's against its f32 sums rounded once.

Tolerances:

- bf16: ``|d| <= 2^-7 |ref| + 1e-3 max|ref|`` per gradient: one bf16 ulp
  and a small absolute term.  Both frameworks round each bf16 product once
  from an f32 sum, but take those sums in other orders on the CPU, so an
  output near zero can round the other way by an ulp of its larger terms.
  Few elements differ at all (printed).  The backward through f32 logits
  that the port ran before misses this bound on every shape.
- f32: rtol 1e-4 / atol 1e-5 (the same plain math differentiated by two
  frameworks, f32 sums in other orders), as ``tests/test_torch_attention.py``
  holds the f32 gradients; and bit for bit against autograd through the
  plain version, which the f32 backward differentiates.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.ops import attention_pallas as jap
from samnerf_tpu_torch.ops import attention as tap

# (B, Kh, Kw, D): a 16-wide grid, ViT-H's head dim, a Kh != Kw grid
SHAPES = [(2, 8, 16, 16), (1, 4, 4, 80), (2, 4, 8, 24)]
BF16_ULP, BF16_ABS = 2.0 ** -7, 1e-3


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _case(seed, b, kh, kw, d):
    """Operands as a seeded layer gives them (q, k, v ~ N(0, 1), rel terms
    N(0, 0.2)) and a cotangent ~ N(0, 1), f32 numpy."""
    rng = np.random.default_rng(seed)
    n = kh * kw
    arrays = [rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3)]
    arrays += [(rng.normal(size=(b, n, s)) * 0.2).astype(np.float32) for s in (kh, kw)]
    return arrays, rng.normal(size=(b, n, d)).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_grads(arrays, g, scale, dtype):
    n = arrays[0].shape[1]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    _, vjp = jax.vjp(lambda *a: jap.flash_attention_relpos(*a, scale, n, n), *jx)
    return [_np(t) for t in vjp(jnp.asarray(g, dtype))]


def _jax_bias_cotangent(arrays, g, scale):
    """The cotangent of the [B, N, Kh, Kw] bias in JAX's bf16 reference
    (``jap.reference_attention_relpos`` with the bias taken as an
    operand), as bf16 values in f32 numpy."""
    q, k, v, rel_h, rel_w = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    b, n, _ = q.shape

    def ref(bias4):
        logits = jnp.einsum("bnd,bmd->bnm", q * scale, k)
        attn = jax.nn.softmax((logits + bias4.reshape(b, n, n)).astype(jnp.float32), axis=-1)
        return jnp.einsum("bnm,bmd->bnd", attn.astype(q.dtype), v)

    _, vjp = jax.vjp(ref, rel_h[:, :, :, None] + rel_w[:, :, None, :])
    return _np(vjp(jnp.asarray(g, jnp.bfloat16))[0])


def _sum_bf16_sequential(x, axis):
    """A sum of bf16 values in bf16, one term after another."""
    acc = torch.from_numpy(np.take(x, 0, axis)).bfloat16()
    for i in range(1, x.shape[axis]):
        acc = acc + torch.from_numpy(np.take(x, i, axis)).bfloat16()
    return acc.float().numpy()


def _round_bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _torch_grads(arrays, g, scale, dtype):
    tx = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = tap.attention_relpos(*tx, scale)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(g).to(dtype))
    for t in tx:
        assert t.grad.dtype == dtype
    return [t.grad.float().numpy() for t in tx]


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_gradients_match_jax(shape, interpret):
    b, kh, kw, d = shape
    arrays, g = _case(11, b, kh, kw, d)
    scale = d ** -0.5
    ref = _jax_grads(arrays, g, scale, jnp.bfloat16)
    ours = _torch_grads(arrays, g, scale, torch.bfloat16)
    dbias = _jax_bias_cotangent(arrays, g, scale)
    for axis, r in ((3, ref[3]), (2, ref[4])):
        np.testing.assert_array_equal(_sum_bf16_sequential(dbias, axis), r)
    ref[3], ref[4] = _round_bf16(dbias.sum(3)), _round_bf16(dbias.sum(2))
    for name, o, r in zip(("q", "k", "v", "rel_h", "rel_w"), ours, ref):
        err = np.abs(o - r)
        bound = BF16_ULP * np.abs(r) + BF16_ABS * np.abs(r).max()
        print(f"{shape} d{name}: {np.mean(o != r):.2%} differ, max |d| {err.max():.3e} "
              f"(max |ref| {np.abs(r).max():.3e})")
        assert np.all(err <= bound), (name, float((err - bound).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_gradients_match_jax_and_the_plain_version(shape, interpret):
    b, kh, kw, d = shape
    arrays, g = _case(12, b, kh, kw, d)
    scale = d ** -0.5
    ref = _jax_grads(arrays, g, scale, jnp.float32)
    ours = _torch_grads(arrays, g, scale, torch.float32)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-5)
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tap.reference_attention_relpos(*tx, scale).backward(torch.from_numpy(g))
    for o, t in zip(ours, tx):
        np.testing.assert_array_equal(o, t.grad.numpy())
