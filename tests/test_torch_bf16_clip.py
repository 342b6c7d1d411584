"""CLIP and the ClipSeg decoder in ``compute_dtype = bfloat16``: the port
against the JAX package on the CPU, with the same f32 parameters.

The tiny towers of ``test_torch_clip.py`` (visual width 64, 2 layers,
patch 8; text width 32, 2 layers, the causal mask, whose f32 ``-inf``
promotes the masked logits to f32 in both packages) and the ``rd64-uni``
decoder on its 32 x 32 token grid (1025 tokens).  The composite tolerance
of ``test_torch_bf16_layers.assert_composite``: the mean absolute error
against JAX's bf16 at most half of JAX's bf16-against-f32 one, the
largest within 2^-5 of the largest output; for the decoder each encoder
layer is held so on JAX's own input to it, and the whole decoder (see its
test) at a mean error no larger than JAX's bf16-against-f32 one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.perception.clipseg import clip_model as jcm
from samnerf_tpu.perception.clipseg import clipseg as jcs
from samnerf_tpu_torch.convert import clip_state_dict_from_jax, clipseg_state_dict_from_jax
from samnerf_tpu_torch.perception.clipseg import clip_model as tcm
from samnerf_tpu_torch.perception.clipseg import clipseg as tcs

from test_torch_bf16_layers import assert_composite
from test_torch_clip import TEXT, VISUAL

BF16 = jnp.bfloat16
DTYPES = (("bf16", BF16), ("f32", jnp.float32))


@pytest.fixture(scope="module")
def towers():
    kv, kt = jax.random.split(jax.random.PRNGKey(4))
    res = VISUAL["input_resolution"]
    vparams = jcm.CLIPVisual(**VISUAL).init(kv, jnp.zeros((1, res, res, 3)))
    tparams = jcm.CLIPText(**TEXT).init(kt, jnp.zeros((1, 77), jnp.int32))
    vis = tcm.CLIPVisual(**VISUAL, compute_dtype=torch.bfloat16, device="meta")
    txt = tcm.CLIPText(**TEXT, compute_dtype="bfloat16", device="meta")
    tcm.load_clip_state_dict(vis, txt, clip_state_dict_from_jax(vparams, tparams), "cpu")
    return vparams, tparams, vis.eval(), txt.eval()


@pytest.mark.parametrize("size", (32, 64))
def test_clip_visual_bf16_matches_jax(towers, size):
    vparams, _, vis, _ = towers
    x = np.random.default_rng(5).normal(size=(2, size, size, 3)).astype(np.float32)
    refs = {name: jcm.CLIPVisual(**VISUAL, compute_dtype=dt).apply(
        vparams, jnp.asarray(x), extract_layers=(0, 1)) for name, dt in DTYPES}
    with torch.no_grad():
        pooled, acts = vis(torch.from_numpy(x), extract_layers=(0, 1))
    assert pooled.dtype == acts[0].dtype == torch.float32
    assert_composite(pooled, refs["bf16"][0], refs["f32"][0], f"CLIP visual pooled {size}")
    for i, a in enumerate(acts):
        assert_composite(a, refs["bf16"][1][i], refs["f32"][1][i],
                         f"CLIP visual activation {i} at {size}")


def test_clip_text_bf16_matches_jax(towers):
    _, tparams, _, txt = towers
    toks = np.zeros((3, 77), np.int32)
    toks[0, :4] = [98, 5, 7, 99]
    toks[1, :3] = [98, 9, 99]
    toks[2] = np.random.default_rng(6).integers(1, 98, 77)
    toks[2, 76] = 99
    refs = {name: jcm.CLIPText(**TEXT, compute_dtype=dt).apply(tparams, jnp.asarray(toks))
            for name, dt in DTYPES}
    with torch.no_grad():
        out = txt(torch.from_numpy(toks))
    assert out.dtype == torch.float32
    assert_composite(out, refs["bf16"], refs["f32"], "CLIP text")


@pytest.fixture(scope="module")
def decoder():
    params = jcs.CLIPDensePredT().init(jax.random.PRNGKey(8), [jnp.zeros((1, 17, 768))] * 3,
                                       jnp.zeros((1, 512)))
    dec = tcs.CLIPDensePredT(compute_dtype=torch.bfloat16, device="meta")
    dec.load_state_dict(clipseg_state_dict_from_jax(params), strict=True, assign=True)
    rng = np.random.default_rng(7)
    acts = [rng.normal(size=(2, 1025, 768)).astype(np.float32) for _ in range(3)]
    cond = rng.normal(size=(2, 512)).astype(np.float32)
    return params, dec.eval(), acts, cond


def test_clipseg_decoder_layers_bf16_match_jax(decoder):
    """Each of the three encoder layers on the input JAX's bf16 decoder
    gives it (captured), against JAX's bf16 and f32 layers on that input."""
    params, dec, acts, cond = decoder
    jdec = jcs.CLIPDensePredT(compute_dtype=BF16)
    _, inter = jdec.apply(params, [jnp.asarray(a) for a in acts], jnp.asarray(cond),
                          capture_intermediates=lambda mdl, _: isinstance(
                              mdl, jcs.TorchTransformerEncoderLayer))
    seen = []
    real_call = jcs.TorchTransformerEncoderLayer.__call__

    def record(self, x):
        seen.append(np.asarray(x))
        return real_call(self, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcs.TorchTransformerEncoderLayer, "__call__", record)
        jdec.apply(params, [jnp.asarray(a) for a in acts], jnp.asarray(cond))
    assert len(seen) == 3
    for i, x in enumerate(seen):
        refs = {name: jcs.TorchTransformerEncoderLayer(64, 4, compute_dtype=dt).apply(
            {"params": params["params"][f"blocks_{i}"]}, jnp.asarray(x)) for name, dt in DTYPES}
        np.testing.assert_array_equal(np.asarray(refs["bf16"]),
                                      np.asarray(inter["intermediates"][f"blocks_{i}"]
                                                 ["__call__"][0]))
        with torch.no_grad():
            out = dec.blocks[i](torch.from_numpy(x))
        assert_composite(out, refs["bf16"], refs["f32"], f"ClipSeg layer {i}")


def test_clipseg_decoder_bf16_matches_jax(decoder):
    """The whole decoder (reductions, FiLM, three layers, the transposed
    convolution): a one-ulp flip in one layer's bf16 product spreads
    through the later layers' bf16 casts and the attention over all 1025
    tokens, so after three post-norm layers the port's bf16 is as far from
    JAX's bf16 as the two are from f32 (mean ratio 0.80 on these weights,
    where each layer alone is at most 0.5, above).  Held at a mean
    absolute error no larger than JAX's own bf16-against-f32 one, the
    largest within 2^-5 of the largest output."""
    params, dec, acts, cond = decoder
    refs = {name: np.asarray(jcs.CLIPDensePredT(compute_dtype=dt).apply(
        params, [jnp.asarray(a) for a in acts], jnp.asarray(cond))) for name, dt in DTYPES}
    with torch.no_grad():
        out = dec([torch.from_numpy(a) for a in acts], torch.from_numpy(cond))
    assert out.shape == (2, 512, 512, 1) and out.dtype == torch.float32
    diff = np.abs(out.numpy() - refs["bf16"])
    bf16_diff = np.abs(refs["bf16"] - refs["f32"])
    print(f"ClipSeg logits: port vs JAX bf16 mean {diff.mean():.3e} max {diff.max():.3e}; "
          f"JAX bf16 vs f32 mean {bf16_diff.mean():.3e}; ratio "
          f"{diff.mean() / bf16_diff.mean():.3f}")
    assert diff.mean() <= bf16_diff.mean()
    assert diff.max() <= 2.0 ** -5 * np.abs(refs["f32"]).max()
