"""The port's ClipSeg decoder and ``ClipSegPredictor`` against the JAX
package's on the CPU.

- ``CLIPDensePredT`` at the full ``rd64-uni`` width (768 -> 64, 3 blocks
  of 4 heads, feed-forward 2048, 16x16 transposed convolution) over 1025
  tokens: seeded JAX weights converted by ``clipseg_state_dict_from_jax``;
  ``__call__``, ``decode`` and ``reduce_activations`` within rtol / atol
  1e-5 (f32 sums in other orders through three post-norm layers).
- A reference-layout decoder state dict survives
  ``convert_clipseg_state_dict`` and ``clipseg_state_dict_from_jax`` bit
  for bit; the port loads it with the unused keys ignored.
- ``ClipSegPredictor`` with a tiny CLIP (``TINY_VISUAL``, ``TINY_TEXT``,
  patched into both packages' pipeline modules here and only here) and
  the full decoder, both loading one pair of reference-layout checkpoints
  that the port writes: ``encode_text``, ``segment`` and
  ``reduced_activations`` of a 512x512 input (a 32x32 token grid through
  the rescaled position grid) within 1e-5, ``decode_rendered`` of a
  32x32x192 grid within 1e-4 on logits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.perception.clipseg import clip_model as jcm
from samnerf_tpu.perception.clipseg import clipseg as jcs
from samnerf_tpu.perception.clipseg import pipeline as jpipe
from samnerf_tpu_torch.convert import clipseg_state_dict_from_jax
from samnerf_tpu_torch.perception.clipseg import clip_model as tcm
from samnerf_tpu_torch.perception.clipseg import clipseg as tcs
from samnerf_tpu_torch.perception.clipseg import pipeline as tpipe
from samnerf_tpu_torch.utils.init import init_state

from test_torch_clip import write_merges

TOL = dict(rtol=1e-5, atol=1e-5)
TINY_VISUAL = dict(input_resolution=64, patch_size=16, width=64, layers=3, heads=4,
                   output_dim=32)
TINY_TEXT = dict(vocab_size=1000, width=32, layers=2, heads=4, output_dim=512)
EXTRACT = (0, 1, 2)
PROMPTS = ["a photo of a dog", "a man is cooking"]


def _image(h=48, w=80, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def write_tiny_checkpoints(root, seed=0, logit_shift=0.0, flat_trans_conv=False):
    """Seeded reference-layout checkpoints of the tiny CLIP (OpenAI keys
    and ``logit_scale``) and of the full decoder (``rd64-uni`` keys and a
    CLIP key it does not use), and a merges file -> their paths.
    ``logit_shift`` goes into the transposed convolution's bias;
    ``flat_trans_conv`` gives each of its channels one weight at all 16x16
    taps, so a 16x16 cell's mean logit varies from token to token as much
    as a pixel's does (a pooled heatmap then spreads over (0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    vis = tcm.CLIPVisual(**TINY_VISUAL, device="meta")
    txt = tcm.CLIPText(**TINY_TEXT, device="meta")
    dec = tcs.CLIPDensePredT(EXTRACT, width=TINY_VISUAL["width"], device="meta")
    clip = {**{f"visual.{k}": v for k, v in init_state(vis, gen, "cpu").items()},
            **init_state(txt, gen, "cpu"), "logit_scale": torch.tensor(4.6)}
    decoder = init_state(dec, gen, "cpu")
    decoder["trans_conv.bias"] += logit_shift
    if flat_trans_conv:
        w = decoder["trans_conv.weight"]    # std 1/16: times 2 gives 64 ** -0.5
        decoder["trans_conv.weight"] = (w[:, :, :1, :1] * 2.0).expand_as(w).clone()
    decoder["clip_model.ln_final.weight"] = torch.ones(3)
    paths = (root / "clip_tiny.pt", root / "rd64_tiny.pth", root / "merges.txt.gz")
    torch.save(clip, paths[0])
    torch.save(decoder, paths[1])
    write_merges(paths[2])
    return paths


def tiny_predictors(root, **checkpoint_kw):
    """(JAX predictor, port predictor on the CPU) over the tiny CLIP and the
    checkpoints of :func:`write_tiny_checkpoints`."""
    clip, decoder, bpe = write_tiny_checkpoints(root, **checkpoint_kw)
    kw = dict(clipseg_checkpoint=str(decoder), clip_checkpoint=str(clip), bpe_path=str(bpe),
              extract_layers=EXTRACT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "CLIPVisual", functools.partial(jcm.CLIPVisual, **TINY_VISUAL))
        mp.setattr(jpipe, "CLIPText", functools.partial(jcm.CLIPText, **TINY_TEXT))
        mp.setattr(tpipe, "CLIPVisual", functools.partial(tcm.CLIPVisual, **TINY_VISUAL))
        mp.setattr(tpipe, "CLIPText", functools.partial(tcm.CLIPText, **TINY_TEXT))
        mp.setattr(tpipe, "CLIPDensePredT",
                   functools.partial(tcs.CLIPDensePredT, width=TINY_VISUAL["width"]))
        return jpipe.ClipSegPredictor(**kw), tpipe.ClipSegPredictor(**kw, device="cpu")


@pytest.fixture(scope="module")
def decoders():
    jdec = jcs.CLIPDensePredT()
    params = jdec.init(jax.random.PRNGKey(0), [jnp.zeros((1, 17, 768))] * 3,
                       jnp.zeros((1, 512)))
    dec = tcs.CLIPDensePredT(device="meta")
    dec.load_state_dict(clipseg_state_dict_from_jax(params), strict=True, assign=True)
    return jdec, params, dec.eval()


def test_decoder_matches_jax(decoders):
    jdec, params, dec = decoders
    rng = np.random.default_rng(1)
    acts = [rng.normal(size=(1, 1025, 768)).astype(np.float32) for _ in range(3)]
    reduced = [rng.normal(size=(1, 1025, 64)).astype(np.float32) for _ in range(3)]
    cond = rng.normal(size=(1, 512)).astype(np.float32)
    with torch.no_grad():
        ours_full = dec([torch.from_numpy(a) for a in acts], torch.from_numpy(cond))
        ours_dec = dec.decode([torch.from_numpy(a) for a in reduced], torch.from_numpy(cond))
        ours_red = dec.reduce_activations([torch.from_numpy(a) for a in acts])
    ref_full = jdec.apply(params, [jnp.asarray(a) for a in acts], jnp.asarray(cond))
    ref_dec = jdec.apply(params, [jnp.asarray(a) for a in reduced], jnp.asarray(cond),
                         method=jcs.CLIPDensePredT.decode)
    ref_red = jdec.apply(params, [jnp.asarray(a) for a in acts],
                         method=jcs.CLIPDensePredT.reduce_activations)
    assert ours_full.shape == ours_dec.shape == (1, 512, 512, 1)
    np.testing.assert_allclose(ours_full.numpy(), np.asarray(ref_full), **TOL)
    np.testing.assert_allclose(ours_dec.numpy(), np.asarray(ref_dec), **TOL)
    assert len(ours_red) == 3 and ours_red[0].shape == (1, 1025, 64)
    for a, r in zip(ours_red, ref_red):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    # the logits are not flat: the check sees the decoder's function
    assert np.asarray(ref_full).std() > 0.01


def test_decoder_state_dict_round_trips_bit_for_bit():
    dec = tcs.CLIPDensePredT(device="meta")
    sd = init_state(dec, torch.Generator().manual_seed(2), "cpu")
    back = clipseg_state_dict_from_jax(jcs.convert_clipseg_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in back.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k
    tcm.load_subset(dec, {**sd, "logit_scale": torch.tensor(1.0)}, "", "cpu")
    assert torch.equal(dec.trans_conv.weight, sd["trans_conv.weight"])
    with pytest.raises(KeyError):
        tcm.load_subset(dec, {k: v for k, v in sd.items() if k != "film_add.bias"}, "", "cpu")


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    return tiny_predictors(tmp_path_factory.mktemp("clipseg"))


def test_predictor_matches_jax(predictors):
    jpred, pred = predictors
    cond, ref_cond = pred.encode_text(PROMPTS), jpred.encode_text(PROMPTS)
    assert cond.shape == (2, 512)
    np.testing.assert_allclose(cond.numpy(), np.asarray(ref_cond), **TOL)
    img = _image()
    logits = pred.segment(img, cond[:1])
    ref = jpred.segment(img, ref_cond[:1])
    assert logits.shape == (512, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    acts, ref_acts = pred.reduced_activations(img), jpred.reduced_activations(img)
    assert [a.shape for a in acts] == [(1025, 1, 64)] * 3
    for a, r in zip(acts, ref_acts):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, r, **TOL)


def test_decode_rendered_matches_jax(predictors):
    jpred, pred = predictors
    grid = np.random.default_rng(3).normal(size=(32, 32, 192)).astype(np.float32)
    cond = np.random.default_rng(4).normal(size=(1, 512)).astype(np.float32)
    ours = pred.decode_rendered(grid, torch.from_numpy(cond))
    ref = jpred.decode_rendered(grid, jnp.asarray(cond))
    assert ours.shape == (512, 512)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_encode_text_needs_merges(tmp_path):
    clip, decoder, _ = write_tiny_checkpoints(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "CLIPVisual", functools.partial(tcm.CLIPVisual, **TINY_VISUAL))
        mp.setattr(tpipe, "CLIPText", functools.partial(tcm.CLIPText, **TINY_TEXT))
        mp.setattr(tpipe, "CLIPDensePredT",
                   functools.partial(tcs.CLIPDensePredT, width=TINY_VISUAL["width"]))
        pred = tpipe.ClipSegPredictor(str(decoder), str(clip), extract_layers=EXTRACT,
                                      device="cpu")
    with pytest.raises(RuntimeError):
        pred.encode_text("a dog")
