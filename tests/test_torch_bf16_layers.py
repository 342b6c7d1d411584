"""``compute_dtype = bfloat16`` layer by layer: the port against the JAX
package on the CPU, the same f32 parameters and numpy inputs in both.

Tolerances, per element:

- bit-exact where the port mirrors every rounding point of flax's bf16
  layer and the f32 sums are short: one ``nn.Dense`` (``F.linear(x, W)``
  rounded, then ``+ b`` rounded) and the field ``MLP`` (ReLU is exact);
- otherwise at most one bf16 ulp, ``|Δ| <= 2^-7 |ref| + 1e-6``, with the
  share of unequal elements printed: ``ConvHead`` (both convolutions in
  bf16, the mean in f32; a 2304-term f32 sum taken in another order can
  round the other way, about 0.1 % of its outputs), ``LayerNorm2d`` (f32
  inside, the input's dtype out), the plain bf16 FLASH-RELPOS against
  JAX's Pallas kernel in interpret mode (both compute in f32 and round the
  output once; their f32 sums differ in order), and the bf16 GELU (JAX's
  op-by-op ``0.5 x erfc(-x sqrt(0.5))``; the two libraries' bf16 erfc
  differ on about 0.02 % of inputs).

Also: the values ``compute_dtype`` takes (the CLI's strings, the torch
dtypes; ``float16`` and the rest raise), ``--model.compute-dtype`` on the
port's CLI, and a bf16 field with ``serve_fuse_mlp`` serving through the
unfused MLP, as the JAX package does (``_mlp_is_fusable``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from samnerf_tpu.fields import mlp as jmlp
from samnerf_tpu.fields import sam_field as jsf
from samnerf_tpu.ops import attention_pallas as jap
from samnerf_tpu.perception.sam import image_encoder as jie
from samnerf_tpu_torch.configs.cli import apply_overrides
from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.fields import mlp as tmlp
from samnerf_tpu_torch.fields import nerfacto_field as tnf
from samnerf_tpu_torch.fields import sam_field as tsf
from samnerf_tpu_torch.models.sam_model import SAMModelConfig
from samnerf_tpu_torch.ops import attention as tap
from samnerf_tpu_torch.perception.sam.common import LayerNorm2d
from samnerf_tpu_torch.utils.dtypes import gelu, linear, resolve_dtype, sigmoid

BF16 = jnp.bfloat16


def f32(x) -> np.ndarray:
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_within_one_ulp(ours, ref, what):
    """|ours - ref| <= 2^-7 |ref| + 1e-6 per element; prints the share of
    elements that differ at all."""
    ours, ref = f32(ours), f32(ref)
    diff = np.abs(ours - ref)
    share = float((diff > 0).mean())
    print(f"{what}: {share:.4%} of {diff.size} elements differ, max {diff.max():.3e}")
    assert (diff <= 2.0 ** -7 * np.abs(ref) + 1e-6).all(), what


def assert_composite(ours, ref_bf16, ref_f32, what):
    """The port's bf16 output against JAX's: its mean absolute error at
    most half of JAX's own bf16-against-f32 mean absolute error, and its
    largest error within four bf16 ulps of the largest output,
    ``2^-5 max|ref|``."""
    ours, ref_bf16, ref_f32 = f32(ours), f32(ref_bf16), f32(ref_f32)
    assert ours.shape == ref_bf16.shape == ref_f32.shape, what
    assert np.isfinite(ours).all(), what
    diff, bf16_diff = np.abs(ours - ref_bf16), np.abs(ref_bf16 - ref_f32)
    print(f"{what}: port vs JAX bf16 mean {diff.mean():.3e} max {diff.max():.3e}; "
          f"JAX bf16 vs f32 mean {bf16_diff.mean():.3e} max {bf16_diff.max():.3e}; "
          f"ratio {diff.mean() / bf16_diff.mean():.3f}; |ref| max {np.abs(ref_f32).max():.3e}")
    assert bf16_diff.mean() > 0.0, what           # the bf16 path is really bf16
    assert diff.mean() <= 0.5 * bf16_diff.mean(), what
    assert diff.max() <= 2.0 ** -5 * np.abs(ref_f32).max(), what


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_dense_is_bit_exact():
    """flax ``nn.Dense(dtype=bf16)`` on f32 params: the product rounded,
    then the bias added and rounded again."""
    x = _normal(0, (64, 48))
    mod = nn.Dense(40, dtype=BF16)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                                p.shape), params)
    ref = mod.apply(params, jnp.asarray(x))
    layer = torch.nn.Linear(48, 40)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(params["params"]["kernel"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(params["params"]["bias"])))
        out = linear(torch.from_numpy(x), layer, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    np.testing.assert_array_equal(f32(out), f32(ref))
    # the fused F.linear(x, W, b) rounds once: not flax's function
    with torch.no_grad():
        fused = torch.nn.functional.linear(torch.from_numpy(x).bfloat16(),
                                           layer.weight.bfloat16(), layer.bias.bfloat16())
    assert (f32(fused) != f32(ref)).any()


@pytest.mark.parametrize("hidden_layers,activation", [(1, None), (2, "sigmoid")])
def test_mlp_matches_jax(hidden_layers, activation):
    """The field MLP in bf16 (input cast, layers and activation in bf16,
    f32 out), with ReLU hidden layers and with the colour head's sigmoid
    (JAX's bf16 logistic, op by op): bit-exact."""
    x = _normal(1, (256, 32))
    act_j = jax.nn.sigmoid if activation else None
    act_t = sigmoid if activation else None
    jm = jmlp.MLP(hidden_dim=64, num_hidden_layers=hidden_layers, out_dim=16,
                  output_activation=act_j, compute_dtype=BF16)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.05, params)        # non-zero biases
    ref = jm.apply(params, jnp.asarray(x))
    tm = tmlp.MLP(32, 64, hidden_layers, 16, output_activation=act_t,
                  compute_dtype=torch.bfloat16, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_array_equal(f32(out), f32(ref))


def test_conv_head_matches_jax():
    """Both convolutions in bf16 (product rounded, bias added), the mean
    in f32: within one bf16 ulp."""
    x = _normal(3, (8, 4, 4, 256))
    jh = jsf.ConvHead(kernel_size=3, compute_dtype=BF16)
    params = jh.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.01, params)
    ref = jh.apply(params, jnp.asarray(x))
    th = tsf.ConvHead(kernel_size=3, compute_dtype=torch.bfloat16, device="cpu")
    th.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = th(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (8, 256)
    assert_within_one_ulp(out, ref, "ConvHead")


def test_bf16_activations_match_jax():
    """The port's bf16 sigmoid is JAX's bit for bit; its GELU within one
    ulp; on f32 both are torch's own."""
    x = _normal(9, (200_000,), 4.0)
    xb = jnp.asarray(x, BF16)
    t = torch.tensor(f32(xb)).bfloat16()
    np.testing.assert_array_equal(f32(sigmoid(t)), f32(jax.nn.sigmoid(xb)))
    assert_within_one_ulp(gelu(t), jax.nn.gelu(xb, approximate=False), "GELU")
    tx = torch.from_numpy(x)
    assert torch.equal(sigmoid(tx), torch.sigmoid(tx))
    assert torch.equal(gelu(tx), torch.nn.functional.gelu(tx))


def test_layernorm2d_returns_the_input_dtype():
    """f32 inside, bf16 out on bf16 input: equal to JAX's on the same bf16
    values (NHWC there, NCHW here)."""
    x = _normal(4, (2, 5, 6, 24), 3.0) + 1.0
    w, b = _normal(5, (24,)), _normal(6, (24,))
    xb = jnp.asarray(x, BF16)
    ref = jie.LayerNorm2d(24).apply({"params": {"weight": jnp.asarray(w),
                                                "bias": jnp.asarray(b)}}, xb)
    ln = LayerNorm2d(24, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        out = ln(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    assert_within_one_ulp(out, ref, "LayerNorm2d")


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape", [(2, 8, 16, 12, 128), (1, 4, 4, 80, 16), (2, 16, 16, 64, 256)])
def test_flash_relpos_bf16_plain_matches_pallas(shape, interpret):
    """bf16 q, k, v, rel_h, rel_w: the port's plain version (and the
    wrapper, which runs it on the CPU) against JAX's Pallas kernel in
    interpret mode, both f32 inside with one rounding of the output."""
    b, kh, kw, d, block = shape
    rng = np.random.default_rng(7)
    n = kh * kw
    arrays = [rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(3)]
    arrays += [(rng.normal(size=(b, n, s)) * 0.2).astype(np.float32) for s in (kh, kw)]
    jx = [jnp.asarray(a, BF16) for a in arrays]
    tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    scale = d ** -0.5
    ref = jap.flash_attention_relpos(*jx, scale, block, block)
    assert ref.dtype == BF16
    plain = tap.reference_attention_relpos(*tx, scale)
    before = (tap.flash_attention_relpos.launches, tap.flash_attention_relpos.launches_bf16)
    wrapped = tap.flash_attention_relpos(*tx, scale)
    assert (tap.flash_attention_relpos.launches,
            tap.flash_attention_relpos.launches_bf16) == before
    assert plain.dtype == wrapped.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(plain), f32(wrapped))
    assert_within_one_ulp(plain, ref, f"FLASH-RELPOS bf16 {shape}")


def test_flash_relpos_rejects_mixed_dtypes():
    t = torch.zeros((1, 16, 8))
    rel = torch.zeros((1, 16, 4))
    with pytest.raises(ValueError):
        tap.flash_attention_relpos(t.bfloat16(), t.bfloat16(), t, rel.bfloat16(),
                                   rel.bfloat16(), 0.5)


def test_flash_relpos_bf16_gradients_flow():
    """``attention_relpos`` on bf16 operands: the backward runs through the
    plain version and returns bf16 gradients."""
    rng = np.random.default_rng(8)
    tx = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().requires_grad_()
          for s in ((2, 16, 8),) * 3 + ((2, 16, 4),) * 2]
    tap.attention_relpos(*tx, 8 ** -0.5).float().square().sum().backward()
    for t in tx:
        assert t.grad.dtype == torch.bfloat16 and bool(torch.isfinite(t.grad).all())
        assert t.grad.abs().sum() > 0


@pytest.mark.parametrize("value,expected", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_resolve_dtype_accepts_the_four_names(value, expected):
    assert resolve_dtype(value) == expected
    assert SAMModelConfig(compute_dtype=value).compute_dtype == expected


@pytest.mark.parametrize("value", ["float16", torch.float16, "bf16", torch.float64, None])
def test_resolve_dtype_rejects_the_rest(value):
    with pytest.raises(ValueError, match="bfloat16"):
        resolve_dtype(value)
    with pytest.raises(ValueError, match="bfloat16"):
        SAMModelConfig(compute_dtype=value)


def test_cli_sets_compute_dtype():
    """``--model.compute-dtype bfloat16`` on the port's CLI; the default
    stays f32 and ``float16`` raises the named error."""
    assert SAMModelConfig().compute_dtype == torch.float32
    assert method_configs()["samnerf_distill"].model.compute_dtype == torch.float32
    cfg = apply_overrides(method_configs()["samnerf_distill"],
                          ["--model.compute-dtype", "bfloat16"])
    assert cfg.model.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        apply_overrides(method_configs()["samnerf_distill"],
                        ["--model.compute-dtype", "float16"])


@pytest.mark.parametrize("dtype,fusable", [(torch.float32, True), (torch.bfloat16, False)])
def test_bf16_mlp_is_not_fused(dtype, fusable, monkeypatch):
    """With ``hash_q8`` and ``fuse_mlp`` a bf16 field serves through Q-ENC
    and the unfused bf16 MLP (FUSED-QMLP computes in f32 only), as the
    JAX package's ``_mlp_is_fusable`` decides."""
    field = tnf.HashMLPDensityField(num_levels=2, max_res=32, log2_hashmap_size=8,
                                    hash_q8=True, fuse_mlp=True, compute_dtype=dtype,
                                    device="cpu")
    assert tnf._mlp_is_fusable(field.mlp) == fusable
    jfield = jmlp.MLP(hidden_dim=16, num_hidden_layers=1, out_dim=1,
                      compute_dtype=jnp.float32 if fusable else BF16)
    from samnerf_tpu.fields.nerfacto_field import _mlp_is_fusable
    assert _mlp_is_fusable(jfield) == fusable
    calls = []
    monkeypatch.setattr(tnf, "_fused_encode_mlp",
                        lambda *a, **k: calls.append(1) or torch.zeros((a[2].shape[0], 1)))
    with torch.no_grad():
        for p in field.parameters():
            p.normal_(0, 0.1)
        out = field(torch.rand((4, 8, 3)) - 0.5)
    assert out.shape == (4, 8, 1) and out.dtype == torch.float32
    assert len(calls) == (1 if fusable else 0)
