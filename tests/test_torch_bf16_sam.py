"""SAM in ``compute_dtype = bfloat16``: the port against the JAX package on
the CPU, both holding the same f32 parameters.

- A tiny ViT (image 128, patch 4, width 64, depth 2, 2 heads, window 8,
  the second layer global over 32 x 32 tokens), both attention branches of
  the global layer: the flash branch (JAX's Pallas FLASH-RELPOS in
  interpret mode with ``jax.default_backend`` patched to "tpu", as the
  fused tests run it; the port's wrapper, which runs its plain bf16
  version on the CPU) and the plain branch (``use_flash=False`` on both
  sides).
- The two-way transformer and the mask decoder at SAM's widths on an 8 x 8
  embedding, with ``test_torch_convert.decoder_state``'s weights.

Tolerance (composites): the port's bf16 against JAX's bf16 must be at most
half of JAX's own bf16-against-f32 error on the same inputs (the mean
absolute error over each output), and its largest error within four bf16
ulps of the largest output (``2^-5 max|ref|``).  The port mirrors JAX's rounding
points (``utils/dtypes.py``), so it agrees with JAX's bf16 better than
bf16 agrees with f32; what is left are single-ulp flips where two f32 sums
taken in other orders round to neighbouring bf16 values, and the ViT's
bf16 residual stream and global attention spread them (about 0.6 % of a
block's outputs from identical inputs, half of the tiny ViT's at the
end).  Outputs are bf16-quantised (the neck's ``LayerNorm2d`` returns
bf16), so the largest error of either comparison is a few ulps of the
largest output; the mean is what separates them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.perception.sam import image_encoder as jie
from samnerf_tpu.perception.sam.build_sam import convert_torch_state_dict
from samnerf_tpu.perception.sam.mask_decoder import MaskDecoder as JaxMaskDecoder
from samnerf_tpu.perception.sam.transformer import TwoWayTransformer as JaxTwoWay
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.ops import attention as tap
from samnerf_tpu_torch.perception.sam import image_encoder as tie
from samnerf_tpu_torch.perception.sam.build_sam import build_sam
from samnerf_tpu_torch.perception.sam.mask_decoder import MaskDecoder

from test_torch_bf16_layers import assert_composite
from test_torch_convert import decoder_state
from test_torch_image_encoder import jax_encoder_params

BF16 = jnp.bfloat16
VIT = dict(img_size=128, patch_size=4, embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0,
           out_chans=32, use_rel_pos=True, window_size=8, global_attn_indexes=(1,))


@pytest.fixture
def flash_backend(monkeypatch):
    """JAX's encoder takes its Pallas flash branch (interpret mode)."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.mark.parametrize("use_flash", [True, False])
def test_vit_bf16_matches_jax(use_flash, request):
    if use_flash:
        request.getfixturevalue("flash_backend")
    _, params = jax_encoder_params(0, **VIT)
    x = np.random.default_rng(3).normal(size=(1, 128, 128, 3)).astype(np.float32)
    refs = {}
    for name, dt in (("bf16", BF16), ("f32", jnp.float32)):
        enc = jie.ImageEncoderViT(**VIT, compute_dtype=dt, use_flash=use_flash)
        refs[name] = enc.apply(params, jnp.asarray(x))
    ours_enc = tie.ImageEncoderViT(**VIT, use_flash=use_flash, compute_dtype="bfloat16",
                                   device="cpu")
    ours_enc.load_state_dict(params_from_jax(params))
    calls = []
    real = tap.flash_attention_relpos
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("samnerf_tpu_torch.ops.attention.flash_attention_relpos",
                   lambda *a: calls.append(a[0].dtype) or real(*a))
        with torch.no_grad():
            ours = ours_enc(torch.from_numpy(x))
    assert calls == ([torch.bfloat16] if use_flash else [])
    assert ours.dtype == torch.float32 and refs["bf16"].dtype == jnp.float32
    assert_composite(ours, refs["bf16"], refs["f32"],
                     f"ViT {'flash' if use_flash else 'plain'} branch")


def _decoder_inputs(seed=1, b=8, n=3, hw=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, hw, hw, 256)).astype(np.float32),
            rng.normal(size=(1, hw, hw, 256)).astype(np.float32),
            rng.normal(size=(b, n, 256)).astype(np.float32),
            (rng.normal(size=(b, hw, hw, 256)) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def decoder_params():
    state = decoder_state(2, for_masks=True)
    return state, convert_torch_state_dict(state, depth=0)["mask_decoder"]


def test_two_way_transformer_bf16_matches_jax(decoder_params):
    state, params = decoder_params
    emb, pe, sparse, _ = _decoder_inputs()
    jin = (jnp.asarray(emb), jnp.asarray(pe), jnp.asarray(sparse))
    refs = {name: JaxTwoWay(depth=2, embedding_dim=256, mlp_dim=2048, num_heads=8,
                            compute_dtype=dt).apply({"params": params["transformer"]},
                                                    jin[0].repeat(8, 0), jin[1], jin[2])
            for name, dt in (("bf16", BF16), ("f32", jnp.float32))}
    dec = MaskDecoder(compute_dtype=torch.bfloat16, device="cpu")
    dec.load_state_dict({k[len("mask_decoder."):]: v for k, v in state.items()
                         if k.startswith("mask_decoder.")})
    with torch.no_grad():
        q, k = dec.transformer(torch.from_numpy(emb).repeat(8, 1, 1, 1),
                               torch.from_numpy(pe), torch.from_numpy(sparse))
    assert q.dtype == k.dtype == torch.float32
    assert_composite(q, refs["bf16"][0], refs["f32"][0], "two-way queries")
    assert_composite(k, refs["bf16"][1], refs["f32"][1], "two-way keys")


def test_mask_decoder_bf16_matches_jax(decoder_params):
    state, params = decoder_params
    emb, pe, sparse, dense = _decoder_inputs()
    refs = {name: JaxMaskDecoder(transformer_dim=256, compute_dtype=dt).apply(
        {"params": params}, *map(jnp.asarray, (emb, pe, sparse, dense)), True)
        for name, dt in (("bf16", BF16), ("f32", jnp.float32))}
    dec = MaskDecoder(compute_dtype="bfloat16", device="cpu")
    dec.load_state_dict({k[len("mask_decoder."):]: v for k, v in state.items()
                         if k.startswith("mask_decoder.")})
    with torch.no_grad():
        masks, iou = dec(*map(torch.from_numpy, (emb, pe, sparse, dense)), True)
    assert masks.shape == (8, 3, 32, 32)
    assert_composite(masks, refs["bf16"][0], refs["f32"][0], "mask logits")
    assert_composite(iou, refs["bf16"][1], refs["f32"][1], "IoU")


def test_build_sam_passes_compute_dtype():
    """``build_sam(..., compute_dtype=)`` reaches the encoder's layers and
    the two-way transformer; the prompt encoder holds it and reads it
    nowhere; the parameters stay f32."""
    sam = build_sam("vit_b", device="meta", compute_dtype=torch.bfloat16)
    enc = sam.image_encoder
    assert enc.compute_dtype == enc.blocks[0].attn.compute_dtype == torch.bfloat16
    assert enc.blocks[0].mlp.compute_dtype == enc.patch_embed.compute_dtype == torch.bfloat16
    layer = sam.mask_decoder.transformer.layers[0]
    assert layer.self_attn.compute_dtype == layer.mlp.compute_dtype == torch.bfloat16
    assert sam.prompt_encoder.compute_dtype == torch.bfloat16
    assert {p.dtype for p in sam.parameters()} == {torch.float32}
    assert build_sam("vit_b", device="meta").image_encoder.compute_dtype == torch.float32
