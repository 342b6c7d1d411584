"""The port's SAM ViT image encoder against the JAX package on the CPU.

The tiny encoder of ``tests/test_sam_golden.py`` (img 64, patch 16, embed
40, depth 3, 2 heads, window 3 over a 4x4 grid padded to 6x6, global
layer 1) with non-zero ``pos_embed`` / ``rel_pos`` (N(0, 0.02), as that
test randomises them).  Weights cross in both directions: the JAX params
through ``convert.params_from_jax``, and the port's state dict, prefixed
``image_encoder.``, through the JAX package's own
``convert_torch_state_dict``, which proves the reference key layout.

Tolerance: rtol 5e-4 / atol 5e-5, that of the golden test (f32 sums in
another order through three blocks and the neck, whose LayerNorm2d makes
the output O(1)).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from samnerf_tpu.perception.sam import image_encoder as jie
from samnerf_tpu.perception.sam.build_sam import convert_torch_state_dict
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.ops import attention as tap
from samnerf_tpu_torch.perception.sam import image_encoder as tie
from samnerf_tpu_torch.utils.init import init_state

TINY = dict(img_size=64, patch_size=16, embed_dim=40, depth=3, num_heads=2,
            mlp_ratio=2.0, out_chans=24, use_rel_pos=True, window_size=3,
            global_attn_indexes=(1,))
TOL = dict(rtol=5e-4, atol=5e-5)


def _image(seed=0, size=64):
    return np.random.RandomState(seed).randn(1, size, size, 3).astype(np.float32)


def jax_encoder_params(seed=0, **spec):
    """Flax-initialised params of the JAX encoder, with its zero-initialised
    position embedding and rel-pos tables drawn from N(0, 0.02)."""
    enc = jie.ImageEncoderViT(**{**TINY, **spec})
    params = enc.init(jax.random.PRNGKey(seed), jnp.asarray(_image(size=enc.img_size)))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = getattr(path[-1], "key", "")
        x = np.asarray(x)
        if name in ("pos_embed", "rel_pos_h", "rel_pos_w"):
            return rng.normal(0.0, 0.02, x.shape).astype(np.float32)
        return x

    return enc, jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("sizes", [(4, 4, 7), (4, 6, 5), (7, 7, 3)])
def test_get_rel_pos_matches_jax(sizes):
    """Sizes (q, k, table length): the second and third resize the table
    (the linear-interpolation branch), the second has q != k."""
    q_size, k_size, length = sizes
    table = np.random.default_rng(0).normal(size=(length, 6)).astype(np.float32)
    ours = tie.get_rel_pos(q_size, k_size, torch.from_numpy(table)).numpy()
    ref = np.asarray(jie.get_rel_pos(q_size, k_size, jnp.asarray(table)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hw,ws", [((4, 4), 3), ((64, 64), 14), ((5, 9), 4)])
def test_window_partition_round_trip_with_padding(hw, ws):
    x = np.random.default_rng(1).normal(size=(2, *hw, 5)).astype(np.float32)
    windows, pad_hw = tie.window_partition(torch.from_numpy(x), ws)
    j_windows, j_pad = jie.window_partition(jnp.asarray(x), ws)
    assert pad_hw == j_pad and pad_hw[0] % ws == 0 and pad_hw[1] % ws == 0
    np.testing.assert_array_equal(windows.numpy(), np.asarray(j_windows))
    back = tie.window_unpartition(windows, ws, pad_hw, hw)
    np.testing.assert_array_equal(back.numpy(), x)


def test_decomposed_rel_pos_matches_jax():
    rng = np.random.default_rng(2)
    attn = rng.normal(size=(3, 12, 12)).astype(np.float32)
    q = rng.normal(size=(3, 12, 8)).astype(np.float32)
    rh, rw = (rng.normal(0, 0.02, (2 * s - 1, 8)).astype(np.float32) for s in (3, 4))
    ours = tie.add_decomposed_rel_pos(*map(torch.from_numpy, (attn, q, rh, rw)),
                                      (3, 4), (3, 4)).numpy()
    ref = jie.add_decomposed_rel_pos(*map(jnp.asarray, (attn, q, rh, rw)), (3, 4), (3, 4))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flash_min_tokens", [1024, 1])
def test_tiny_encoder_matches_jax(flash_min_tokens):
    """Weights from ``params_from_jax``.  ``flash_min_tokens`` 1 routes the
    global layer through the FLASH-RELPOS wrapper (its plain version on
    the CPU) and 1024 through the encoder's own plain attention; the JAX
    encoder takes its plain path on the CPU."""
    enc, params = jax_encoder_params(0)
    x = _image(3)
    ref = np.asarray(enc.apply(params, jnp.asarray(x)))
    ours = tie.ImageEncoderViT(**TINY, flash_min_tokens=flash_min_tokens, device="cpu")
    ours.load_state_dict(params_from_jax(params))
    assert float(ours.blocks[1].attn.rel_pos_h.detach().abs().min()) > 0.0
    before = tap.flash_attention_relpos.launches
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    assert tap.flash_attention_relpos.launches == before
    assert out.shape == (1, 4, 4, 24)
    np.testing.assert_allclose(out, ref, **TOL)


def test_state_dict_has_the_reference_layout():
    """The port's seeded state dict under ``image_encoder.`` converts with
    the JAX package's ``convert_torch_state_dict`` and gives the same
    encoder output there."""
    ours = tie.ImageEncoderViT(**TINY, device="cpu")
    state = init_state(ours, torch.Generator().manual_seed(4), device="cpu")
    ours.load_state_dict(state)
    assert float(state["blocks.1.attn.rel_pos_w"].std()) > 0.01
    sd = {f"image_encoder.{k}": v for k, v in state.items()}
    params = convert_torch_state_dict(sd, depth=TINY["depth"])["image_encoder"]
    x = _image(5)
    ref = jie.ImageEncoderViT(**TINY).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_attention_gradients_flow_through_the_kernel_route():
    """The global layer's attention under autograd on the kernel route
    gives the plain route's gradients (rtol 1e-4 / atol 1e-5, those of
    ``test_torch_attention.py``: one function, summed in another order)."""
    grads = []
    for flash_min_tokens in (1, 1024):
        attn = tie.Attention(16, num_heads=2, use_rel_pos=True, input_size=(4, 4),
                             flash_min_tokens=flash_min_tokens, device="cpu")
        attn.load_state_dict(init_state(attn, torch.Generator().manual_seed(6), "cpu"))
        x = torch.from_numpy(_image(7, 4)[..., :1].repeat(16, -1))
        attn(x).square().sum().backward()
        grads.append({n: p.grad for n, p in attn.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=1e-4, atol=1e-5)
