"""The port's CLIP (tokenizer, visual and text towers, the converters)
against the JAX package's on the CPU.

- Tokens: equal, on a battery of strings and on random Unicode text, with
  one merges file written here (the published vocabulary is not needed:
  the merges build the battery's words, so byte-pair merges run).  The
  JAX tokenizer splits with ``regex``; the port with ``re`` and
  ``unicodedata``.
- ``rescaled_pos_emb`` against ``jax.image.resize(..., "bicubic")`` at
  14x14 -> 32x32 and at a non-square size that grows one axis and shrinks
  the other: atol 1e-6 at 32x32 (f32 weights equal, a few taps summed in
  another order), 3e-6 at the other size (JAX's own rounding of its
  weights there; see the test).
- ``CLIPVisual`` (width 64, 2 layers, patch 8, input 32; inputs 32x32
  and 64x64, the second through the rescaled grid) and ``CLIPText``
  (vocabulary 100, width 32, 2 layers): seeded JAX weights converted by
  ``clip_state_dict_from_jax``; rtol / atol 1e-5 (f32 sums in other
  orders through two blocks; activations O(1)).
- A reference-layout state dict survives ``convert_clip_state_dict`` and
  ``clip_state_dict_from_jax`` bit for bit.
"""
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.perception.clipseg import clip_model as jcm
from samnerf_tpu.perception.clipseg import tokenizer as jtok
from samnerf_tpu_torch.convert import clip_state_dict_from_jax
from samnerf_tpu_torch.perception.clipseg import clip_model as tcm
from samnerf_tpu_torch.perception.clipseg import tokenizer as ttok
from samnerf_tpu_torch.utils.init import init_state

TOL = dict(rtol=1e-5, atol=1e-5)
VISUAL = dict(input_resolution=32, patch_size=8, width=64, layers=2, heads=4, output_dim=16)
TEXT = dict(vocab_size=100, width=32, layers=2, heads=4, output_dim=16)

BATTERY = [
    "a photo of a dog", "A man is cooking", "the RED car, parked!",
    "room 101 has 3 chairs and 12.5 m² of floor", "x² + y² = r²",
    "it's what they're saying: we've, I'm, you'll, he'd, don't, 'twas",
    "''s ' s 'S 'RE", "café naïve résumé Ångström", "東京タワーと北京の天安門", "한국어 텍스트",
    "emoji 😀🎉 and dingbats ✓✗", "tabs\tand\nnew lines　ideographic space",
    "&amp; &lt;b&gt; html &quot;entities&quot;", "<|startoftext|>hello<|endoftext|>",
    "İstanbul ſtraße ΣΊΣΥΦΟΣ ͅ ⅻ ①②", "---===***", "",
    " ".join(["word"] * 40) + " " + " ".join(f"n{i}" for i in range(40)),
]


def write_merges(path, texts=BATTERY, extra=("photo", "cooking", "chair", "floor")):
    """A gzip merges file in CLIP's format (a header line, then one merge
    per line) whose merges build each word of ``texts`` left to right."""
    enc = jtok.bytes_to_unicode()
    merges = []
    for text in list(texts) + list(extra):
        for word in jtok.whitespace_clean(jtok.basic_clean(text)).lower().split(" "):
            if len(word) < 2:
                continue
            sym = ["".join(enc[b] for b in ch.encode("utf-8")) for ch in word]
            sym[-1] += "</w>"
            acc = sym[0]
            for s in sym[1:]:
                if (acc, s) not in merges:
                    merges.append((acc, s))
                acc += s
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return path


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    return jtok.SimpleTokenizer(path), ttok.SimpleTokenizer(path)


def test_tokens_match_jax(tokenizers):
    jt, tt = tokenizers
    ours, ref = ttok.tokenize(tt, BATTERY), jtok.tokenize(jt, BATTERY)
    assert ours.dtype == ref.dtype == np.int32 and ours.shape == (len(BATTERY), 77)
    np.testing.assert_array_equal(ours, ref)
    # the merges ran, the long text was cut with end-of-text last
    assert len(tt.encode("a photo of a dog")) == 5
    eot = tt.encoder["<|endoftext|>"]
    assert ours[-1, -1] == eot and (ours == eot).any(axis=1).all()
    for text in BATTERY:
        assert tt.encode(text) == jt.encode(text), text


def test_pre_tokenizer_matches_regex_on_random_text(tokenizers):
    """Random strings over ASCII, Latin-1, Greek, combining marks, CJK,
    symbols, digits of other scripts and white space."""
    jt, _ = tokenizers
    rng = np.random.default_rng(0)
    ranges = [(0x20, 0x7f), (0xa0, 0x180), (0x300, 0x3ff), (0x660, 0x66a), (0x2000, 0x2070),
              (0x2150, 0x2190), (0x2460, 0x24ff), (0x3000, 0x3040), (0x4e00, 0x4e40),
              (0x1f600, 0x1f610)]
    for _ in range(300):
        chars = []
        for _ in range(rng.integers(1, 40)):
            lo, hi = ranges[rng.integers(len(ranges))]
            chars.append(chr(rng.integers(lo, hi)))
        text = jtok.whitespace_clean("".join(chars)).lower()
        assert ttok.pre_tokenize(text) == jt.pat.findall(text), repr(text)


def test_bytes_to_unicode_matches_jax():
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()


@pytest.mark.parametrize("new_size", [(32, 32), (20, 9)])
def test_rescaled_pos_emb_matches_jax_image_resize(new_size):
    width = 8
    vis = tcm.CLIPVisual(input_resolution=224, patch_size=16, width=width, layers=0,
                         output_dim=4, device="cpu")
    pe = np.random.default_rng(1).normal(size=(14 * 14 + 1, width)).astype(np.float32)
    with torch.no_grad():
        vis.positional_embedding.copy_(torch.from_numpy(pe))
        ours = vis.rescaled_pos_emb(new_size).numpy()
    grid = jax.image.resize(jnp.asarray(pe[1:].reshape(14, 14, width)), (*new_size, width),
                            method="bicubic")
    assert ours.shape == (new_size[0] * new_size[1] + 1, width)
    np.testing.assert_array_equal(ours[0], pe[0])
    # at sizes other than 32, XLA's fused weight computation inside JAX's
    # jitted resize rounds the weights by up to 4e-7 (a column's sum is
    # off 1 by up to 3.6e-7), which moves its outputs 1.4e-6 to 2.4e-6
    # from the exact product of its own formula; the port's weights are
    # that formula in f32 (within 3e-7 of exact), so 3e-6 there
    atol = 1e-6 if new_size == (32, 32) else 3e-6
    np.testing.assert_allclose(ours[1:], np.asarray(grid).reshape(-1, width), rtol=0,
                               atol=atol)


def _jax_towers(seed=0):
    jv, jt = jcm.CLIPVisual(**VISUAL), jcm.CLIPText(**TEXT)
    kv, kt = jax.random.split(jax.random.PRNGKey(seed))
    res = VISUAL["input_resolution"]
    vparams = jv.init(kv, jnp.zeros((1, res, res, 3)))
    tparams = jt.init(kt, jnp.zeros((1, 77), jnp.int32))
    return jv, vparams, jt, tparams


def _port_towers(vparams, tparams):
    vis, txt = tcm.CLIPVisual(**VISUAL, device="meta"), tcm.CLIPText(**TEXT, device="meta")
    tcm.load_clip_state_dict(vis, txt, clip_state_dict_from_jax(vparams, tparams), "cpu")
    return vis.eval(), txt.eval()


@pytest.fixture(scope="module")
def towers():
    jv, vparams, jt, tparams = _jax_towers()
    return (jv, vparams, jt, tparams), _port_towers(vparams, tparams)


@pytest.mark.parametrize("size", (32, 64))
def test_clip_visual_matches_jax(towers, size):
    (jv, vparams, _, _), (vis, _) = towers
    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(np.float32)
    ref_pooled, ref_acts = jv.apply(vparams, jnp.asarray(x), extract_layers=(0, 1))
    with torch.no_grad():
        pooled, acts = vis(torch.from_numpy(x), extract_layers=(0, 1))
    n = (size // VISUAL["patch_size"]) ** 2 + 1
    assert len(acts) == len(ref_acts) == 2 and acts[0].shape == (2, n, VISUAL["width"])
    for a, r in zip(acts, ref_acts):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), **TOL)


def test_clip_text_matches_jax(towers):
    (_, _, jt, tparams), (_, txt) = towers
    toks = np.zeros((3, 77), np.int32)
    toks[0, :4] = [98, 5, 7, 99]
    toks[1, :3] = [98, 9, 99]
    toks[2, :77] = np.random.default_rng(3).integers(1, 98, 77)
    toks[2, 76] = 99
    ref = jt.apply(tparams, jnp.asarray(toks))
    with torch.no_grad():
        out = txt(torch.from_numpy(toks))
    assert out.shape == (3, TEXT["output_dim"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_clip_state_dict_round_trips_bit_for_bit():
    vis, txt = tcm.CLIPVisual(**VISUAL, device="meta"), tcm.CLIPText(**TEXT, device="meta")
    gen = torch.Generator().manual_seed(4)
    sd = {**{f"visual.{k}": v for k, v in init_state(vis, gen, "cpu").items()},
          **init_state(txt, gen, "cpu"), "logit_scale": torch.tensor(4.6)}
    back = clip_state_dict_from_jax(*jcm.convert_clip_state_dict(sd))
    assert set(back) == set(sd) - {"logit_scale"}
    for k, v in back.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k
    # and it loads into the port strictly, the unused key ignored
    tcm.load_clip_state_dict(vis, txt, sd, "cpu")
    assert torch.equal(vis.transformer.resblocks[1].attn.in_proj_weight,
                       sd["visual.transformer.resblocks.1.attn.in_proj_weight"])
    with pytest.raises(KeyError):
        tcm.load_clip_state_dict(vis, txt, {k: v for k, v in sd.items()
                                            if k != "ln_final.bias"}, "cpu")
