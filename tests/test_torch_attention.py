"""The port's attention with decomposed rel-pos (``ops/attention.py``)
against the JAX package on the CPU: the plain version against
``reference_attention_relpos``, the wrapper (which runs the plain version
for CPU tensors) against ``flash_attention_relpos`` in Pallas interpret
mode, and the autograd gradients of all five inputs against ``jax.grad``
through the JAX custom vjp.

Tolerances: outputs rtol 2e-4 / atol 2e-5, as
``tests/test_attention_pallas.py`` holds the JAX kernel to its reference
(f32 softmax sums in another order); gradients rtol 1e-4 / atol 1e-5
(the same plain math differentiated by two frameworks).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from samnerf_tpu.ops import attention_pallas as jap
from samnerf_tpu_torch.ops import attention as tap

# (B, Kh, Kw, D, block): non-power-of-two D, Kh != Kw
SHAPES = [(2, 8, 16, 12, 128), (3, 16, 8, 20, 128), (1, 4, 4, 80, 16)]


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, b, kh, kw, d):
    rng = np.random.default_rng(seed)
    n = kh * kw
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3))
    rel_h = (rng.normal(size=(b, n, kh)) * 0.2).astype(np.float32)
    rel_w = (rng.normal(size=(b, n, kw)) * 0.2).astype(np.float32)
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_wrapper_match_jax(shape, interpret):
    b, kh, kw, d, block = shape
    arrays = _inputs(0, b, kh, kw, d)
    scale = d ** -0.5
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    j_ref = np.asarray(jap.reference_attention_relpos(*jx, scale))
    j_flash = np.asarray(jap.flash_attention_relpos(*jx, scale, block, block))
    t_ref = tap.reference_attention_relpos(*tx, scale).numpy()
    before = tap.flash_attention_relpos.launches
    t_wrap = tap.flash_attention_relpos(*tx, scale).numpy()
    assert tap.flash_attention_relpos.launches == before      # CPU: no kernel
    np.testing.assert_allclose(t_ref, j_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t_wrap, j_flash, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_gradients_match_jax_custom_vjp(shape, interpret):
    b, kh, kw, d, block = shape
    arrays = _inputs(1, b, kh, kw, d)
    cot = np.random.default_rng(2).normal(size=arrays[0].shape).astype(np.float32)
    scale = d ** -0.5

    def loss(*a):
        return (jap.flash_attention_relpos(*a, scale, block, block) * cot).sum()

    j_grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in arrays])
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tap.attention_relpos(*tx, scale).backward(torch.from_numpy(cot))
    for name, t, g in zip(("q", "k", "v", "rel_h", "rel_w"), tx, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "head_dim", "grid"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, rel_h, rel_w = (torch.from_numpy(a) for a in _inputs(3, 2, 4, 4, 8))
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        v = v[:, :8].contiguous()
    elif bad == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "head_dim":
        q, k, v = (torch.zeros((2, 16, tap.MAX_HEAD_DIM + 8)) for _ in range(3))
    else:
        rel_w = torch.zeros((2, 16, 5))          # Kh * Kw != N
    with pytest.raises(ValueError):
        tap.flash_attention_relpos(q, k, v, rel_h, rel_w, 0.5)
