"""The port's prompt buckets and masked padding (``Sam.decode_masks(
num_valid_points=...)``) and its predictor's static buffers, against the
JAX package's on the CPU, with the small SAM of
``test_torch_predictor.py`` (a 4x4 embedding of a 64x64 input, the
decoder at its shared widths, one state dict loaded into both packages).

On the card the predictor replays a CUDA graph per encode and per decode
signature; here the same code runs eagerly through the same buffers and
buckets (``tests/test_torch_cuda_dispatch.py`` holds the replays against
eager calls on a card).

Tolerances: low-res logits and IoU rtol 1e-4 / atol 1e-4 (``TOL``: f32 sums
in another order through the two-way transformer; logits are O(1-10)),
both for the port against JAX and for the port's bucketed, masked decode
against its own unpadded one (the masked keys get a weight of exactly 0,
so the two differ only in the order of the sums); masks exactly equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.perception.sam.build_sam import convert_torch_state_dict
from samnerf_tpu.perception.sam.predictor import (SamPredictor as JaxPredictor,
                                                  _bucket as jax_bucket)
from samnerf_tpu.perception.sam.sam import Sam as JaxSam
from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.predictor import (_PROMPT_BUCKETS, SamPredictor,
                                                        _bucket)
from samnerf_tpu_torch.perception.sam.sam import Sam

from test_torch_predictor import SMALL, TOL, jax_small_sam, small_sam_state

torch.set_num_threads(1)

VALID = {1: 1, 4: 3, 16: 9}            # real points in each tested bucket
_MODELS = []                            # the ``models`` fixture's, for _jax_decodes
BOX = np.array([[6.0, 10.0, 50.0, 58.0]], np.float32)


@pytest.fixture(scope="module")
def models():
    state = small_sam_state(0)
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL, device="cpu"), device="cpu")
    sam.load_state_dict(state)
    params = {"params": convert_torch_state_dict(state, depth=SMALL["depth"])}
    _MODELS[:] = [(sam, jax_small_sam(), params)]
    return _MODELS[0]


def _prompt(bucket, seed=0):
    """features [1, 4, 4, 256], and coords [1, bucket, 2] / labels [1,
    bucket] of ``VALID[bucket]`` real points padded with label -1."""
    rng = np.random.default_rng(seed + bucket)
    feats = rng.normal(size=(1, 4, 4, 256)).astype(np.float32)
    n = VALID[bucket]
    coords = np.zeros((1, bucket, 2), np.float32)
    labels = -np.ones((1, bucket), np.int64)
    coords[0, :n] = rng.uniform(0, 64, (n, 2))
    labels[0, :n] = rng.integers(0, 2, n)
    return feats, coords, labels, n


def _port_decode(sam, feats, coords, labels, box, multimask, n=None):
    boxes = torch.from_numpy(BOX) if box else None
    low, iou = sam.decode_masks(torch.from_numpy(feats),
                                (torch.from_numpy(coords), torch.from_numpy(labels)),
                                boxes, None, multimask, num_valid_points=n)
    return low.numpy(), iou.numpy()


def test_buckets_are_jax_buckets():
    for n in (1, 2, 4, 5, 16, 17, 64, 100, 256, 1000, 1024, 2048, 2049, 5000):
        assert _bucket(n) == jax_bucket(n)
    assert _PROMPT_BUCKETS == (1, 4, 16, 64, 256, 1024, 2048)


@functools.lru_cache(maxsize=None)
def _jax_decodes(bucket, box):
    """JAX's ``Sam.decode_masks`` of ``_prompt(bucket)`` with and without
    multimask, jitted once per (bucket, box) (op by op, each new shape
    costs a few seconds on the CPU)."""
    _, jsam, params = _MODELS[0]
    feats, coords, labels, n = _prompt(bucket)

    def decode(p, f, c, lab, nv):
        return {m: jsam.apply(p, f, (c, lab), jnp.asarray(BOX) if box else None, None, m,
                              num_valid_points=nv, method=JaxSam.decode_masks)
                for m in (True, False)}

    out = jax.jit(decode)(params, feats, coords, labels.astype(np.int32), n)
    return {m: tuple(np.asarray(t) for t in v) for m, v in out.items()}


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_masked_decode_matches_jax(models, bucket, box, multimask):
    sam = models[0]
    feats, coords, labels, n = _prompt(bucket)
    low, iou = _port_decode(sam, feats, coords, labels, box, multimask, n)
    r_low, r_iou = _jax_decodes(bucket, box)[multimask]
    assert low.shape == r_low.shape == (1, 3 if multimask else 1, 16, 16)
    np.testing.assert_allclose(low, np.asarray(r_low), **TOL)
    np.testing.assert_allclose(iou, np.asarray(r_iou), **TOL)


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_masked_decode_matches_the_unpadded_decode(models, bucket, box, multimask):
    """n real points padded to the bucket and masked against the same n
    points alone (the reference's layout: the prompt encoder adds its one
    not-a-point pad without a box, the two box corners with one)."""
    sam = models[0]
    feats, coords, labels, n = _prompt(bucket, seed=10)
    low, iou = _port_decode(sam, feats, coords, labels, box, multimask, n)
    ref_low, ref_iou = _port_decode(sam, feats, coords[:, :n], labels[:, :n], box,
                                    multimask)
    np.testing.assert_allclose(low, ref_low, **TOL)
    np.testing.assert_allclose(iou, ref_iou, **TOL)
    np.testing.assert_array_equal(low > 0.0, ref_low > 0.0)
    if bucket > n:      # unmasked, the padding moves the masks
        pad_low, _ = _port_decode(sam, feats, coords, labels, box, multimask)
        assert np.abs(pad_low - ref_low).max() > 1e-3


def test_decode_masks_without_num_valid_points_is_unchanged(models):
    """``None`` is the decode the serve frame captures: the padded points
    take part as not-a-point tokens, as before."""
    sam, jsam, params = models
    feats, coords, labels, _ = _prompt(4, seed=3)
    low, iou = _port_decode(sam, feats, coords, labels, False, False)
    r_low, r_iou = jax.jit(lambda p, f, c, lab: jsam.apply(
        p, f, (c, lab), None, None, False, method=JaxSam.decode_masks))(
            params, feats, coords, labels.astype(np.int32))
    np.testing.assert_allclose(low, np.asarray(r_low), **TOL)
    np.testing.assert_allclose(iou, np.asarray(r_iou), **TOL)


@pytest.fixture(scope="module")
def jax_predictor(models):
    """One JAX predictor for the module: its jitted encode and decodes
    compile once."""
    _, jsam, params = models
    return JaxPredictor(jsam, params)


@pytest.fixture
def predictors(models, jax_predictor):
    return SamPredictor(models[0]), jax_predictor


def _image(seed=5, h=48, w=80):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("clicks", [3, 5])
def test_predict_matches_jax(predictors, clicks):
    """``predict`` pads 3 clicks to bucket 4 and 5 to bucket 16, as the
    JAX predictor does, with and without a box."""
    ours, ref = predictors
    img = _image()
    ours.set_image(img)
    ref.set_image(img)
    rng = np.random.default_rng(clicks)
    kw = dict(point_coords=rng.uniform(0, 48, (clicks, 2)),
              point_labels=rng.integers(0, 2, clicks))
    for box in (None, np.array([4.0, 2.0, 70.0, 44.0])):
        masks, iou, low = ours.predict(**kw, box=box)
        r_logits, r_iou, r_low = ref.predict(**kw, box=box, return_logits=True)
        np.testing.assert_allclose(low, r_low, **TOL)
        np.testing.assert_allclose(iou, r_iou, **TOL)
        np.testing.assert_array_equal(masks, np.asarray(r_logits) > 0.0)
    b = jax_bucket(clicks)
    assert set(ours._prompts) == {(b, False, False, True), (b, True, False, True)}
    assert set(ours._prompts) <= set(ref._decode)


def test_predict_batched_matches_jax(predictors):
    ours, ref = predictors
    img = _image(8)
    ours.set_image(img)
    ref.set_image(img)
    coords = np.random.default_rng(2).uniform(0, 64, (6, 1, 2)).astype(np.float32)
    labels = np.ones((6, 1), np.int32)
    masks, iou, low = ours.predict_batched(coords, labels)
    r_logits, r_iou, r_low = ref.predict_batched(coords, labels, return_logits=True)
    np.testing.assert_allclose(low, r_low, **TOL)
    np.testing.assert_allclose(iou, r_iou, **TOL)
    np.testing.assert_array_equal(masks, np.asarray(r_logits) > 0.0)
    assert set(ours._prompts) == {("batched", (6, 1, 2), True)}


def test_clicks_within_a_bucket_share_one_decode(models):
    """1 click takes bucket 1; 2, 3 and 4 clicks bucket 4: two decode
    signatures, each with its static prompt refilled per call."""
    ours = SamPredictor(models[0])
    ours.set_image(_image())
    for n in (1, 2, 3, 4):
        ours.predict(point_coords=np.full((n, 2), 20.0), point_labels=np.ones(n))
    assert set(ours._prompts) == {(1, False, False, True), (4, False, False, True)}
    assert ours.calls == {"eager": 5, "captured": 0, "replayed": 0}     # 1 encode, 4 decodes


def test_an_embedding_outlives_the_next_set_image(predictors):
    ours, ref = predictors
    ours.set_image(_image(1))
    first = ours.get_image_embedding()
    ours.set_image(_image(2))
    ref.set_image(_image(1))
    np.testing.assert_allclose(first.numpy(), np.asarray(ref.get_image_embedding()), **TOL)
    assert not torch.equal(first, ours.get_image_embedding())


def test_set_feature_after_set_image_reads_the_rendered_grid(models, predictors):
    """The features buffer holds the rendered grid, zero-padded, and the
    decode reads it, not the encoded image before it."""
    ours, ref = predictors
    fresh = SamPredictor(models[0])
    ours.set_image(_image(3))
    feat = np.random.default_rng(4).normal(size=(4, 3, 256)).astype(np.float32)
    for p in (ours, ref, fresh):
        p.set_feature(feat, (64, 48))
    padded = np.zeros((1, 4, 4, 256), np.float32)
    padded[0, :, :3] = feat
    np.testing.assert_array_equal(ours.get_image_embedding().numpy(), padded)
    np.testing.assert_array_equal(np.asarray(ref.get_image_embedding()), padded)
    kw = dict(point_coords=np.array([[20.0, 30.0]]), point_labels=np.array([1]))
    got, want = ours.predict(**kw), fresh.predict(**kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    r_logits, r_iou, r_low = ref.predict(**kw, return_logits=True)
    np.testing.assert_allclose(got[2], r_low, **TOL)
    np.testing.assert_array_equal(got[0], np.asarray(r_logits) > 0.0)
