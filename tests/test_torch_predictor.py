"""The port's ``SamPredictor`` and ``Sam`` with an image encoder against
the JAX package's on the CPU.

A small SAM: the tiny encoder of ``test_torch_image_encoder.py`` with a
256-channel neck (4x4 embedding of a 64x64 input), and the prompt encoder
and mask decoder at their shared widths with the weights of
``test_torch_convert.decoder_state(for_masks=True)``, which put mask
boundaries inside the frame.  One reference-layout state dict loads
into the port and, through ``convert_torch_state_dict``, into JAX.

The JAX predictor pads clicks to static buckets and masks the padding;
the port passes exactly the n clicks and its prompt encoder adds the one
not-a-point pad, as the reference does.  Tolerances: low-res logits and
IoU rtol 1e-4 / atol 1e-4 (f32 sums in another order through the encoder
and the two-way transformer; logits are O(1-10)); masks exactly equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from samnerf_tpu.perception.sam import image_encoder as jie
from samnerf_tpu.perception.sam.build_sam import convert_torch_state_dict
from samnerf_tpu.perception.sam.mask_decoder import MaskDecoder as JaxMaskDecoder
from samnerf_tpu.perception.sam.predictor import SamPredictor as JaxPredictor
from samnerf_tpu.perception.sam.prompt_encoder import PromptEncoder as JaxPromptEncoder
from samnerf_tpu.perception.sam.sam import Sam as JaxSam
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam
from samnerf_tpu_torch.utils.init import init_state

from test_torch_convert import decoder_state
from test_torch_image_encoder import TINY

SMALL = dict(TINY, out_chans=256)
TOL = dict(rtol=1e-4, atol=1e-4)


def small_sam_state(seed=0):
    """A reference-layout state dict of the small SAM."""
    enc = ImageEncoderViT(**SMALL, device="meta")
    state = {f"image_encoder.{k}": v for k, v in
             init_state(enc, torch.Generator().manual_seed(seed), "cpu").items()}
    return {**state, **decoder_state(seed, for_masks=True)}


def jax_small_sam():
    return JaxSam(
        image_encoder=jie.ImageEncoderViT(**SMALL),
        prompt_encoder=JaxPromptEncoder(embed_dim=256, image_embedding_size=(4, 4),
                                        input_image_size=(64, 64), mask_in_chans=16),
        mask_decoder=JaxMaskDecoder(transformer_dim=256, num_multimask_outputs=3,
                                    iou_head_depth=3, iou_head_hidden_dim=256))


@pytest.fixture(scope="module")
def predictors():
    state = small_sam_state(0)
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL, device="cpu"), device="cpu")
    sam.load_state_dict(state)
    params = convert_torch_state_dict(state, depth=SMALL["depth"])
    return SamPredictor(sam), JaxPredictor(jax_small_sam(), {"params": params})


def _image(h=48, w=80):
    return np.random.default_rng(5).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same_masks(ours, ref_logits):
    np.testing.assert_array_equal(ours, np.asarray(ref_logits) > 0.0)


PROMPTS = {
    "one_click": dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1])),
    "three_clicks": dict(point_coords=np.array([[30.0, 20.0], [60.0, 10.0], [10.0, 40.0]]),
                         point_labels=np.array([1, 0, 1])),
    "box": dict(box=np.array([8.0, 6.0, 70.0, 40.0])),
    "box_and_click": dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1]),
                          box=np.array([8.0, 6.0, 70.0, 40.0])),
    "click_and_mask": dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1]),
                           mask_input=np.random.default_rng(7).normal(size=(1, 16, 16))),
}


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
@pytest.mark.parametrize("multimask", [True, False])
def test_set_image_and_predict_match_jax(predictors, prompt, multimask):
    ours, ref = predictors
    img = _image()
    ours.set_image(img)
    ref.set_image(img)
    assert ours.input_size == ref.input_size == (38, 64)
    np.testing.assert_allclose(ours.get_image_embedding().numpy(),
                               np.asarray(ref.get_image_embedding()), **TOL)
    kw = dict(PROMPTS[prompt], multimask_output=multimask)
    masks, iou, low = ours.predict(**kw)
    r_logits, r_iou, r_low = ref.predict(**kw, return_logits=True)
    assert masks.shape == r_logits.shape == (3 if multimask else 1, 48, 80)
    np.testing.assert_allclose(low, r_low, **TOL)
    np.testing.assert_allclose(iou, r_iou, **TOL)
    _same_masks(masks, r_logits)


def test_sam_forward_matches_jax(predictors):
    """``Sam.__call__``: preprocess, encode and decode in one call."""
    ours, ref = predictors
    img = _image(64, 64).astype(np.float32)[None]
    pts = np.array([[[12.0, 40.0], [50.0, 30.0]]], np.float32)
    labels = np.array([[1, 0]])
    with torch.no_grad():
        low, iou = ours.model(torch.from_numpy(img),
                              (torch.from_numpy(pts), torch.from_numpy(labels)))
    r_low, r_iou = ref.model.apply(ref.params, jnp.asarray(img),
                                   (jnp.asarray(pts), jnp.asarray(labels, jnp.int32)))
    np.testing.assert_allclose(low.numpy(), np.asarray(r_low), **TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(r_iou), **TOL)


def test_set_feature_and_predict_batched_match_jax(predictors):
    """A rectangular rendered embedding through ``set_feature``, then two
    prompt sets at once."""
    ours, ref = predictors
    feat = np.random.default_rng(6).normal(size=(3, 4, 256)).astype(np.float32)
    ours.set_feature(feat, (48, 64))
    ref.set_feature(feat, (48, 64))
    assert ours.input_size == ref.input_size == (48, 64)
    np.testing.assert_array_equal(ours.get_image_embedding().numpy(),
                                  np.asarray(ref.get_image_embedding()))
    masks, iou, low = ours.predict(point_coords=np.array([[20.0, 30.0]]),
                                   point_labels=np.array([1]))
    r_logits, r_iou, r_low = ref.predict(point_coords=np.array([[20.0, 30.0]]),
                                         point_labels=np.array([1]), return_logits=True)
    np.testing.assert_allclose(low, r_low, **TOL)
    np.testing.assert_allclose(iou, r_iou, **TOL)
    _same_masks(masks, r_logits)
    coords = np.array([[[10.0, 12.0], [40.0, 30.0]], [[50.0, 8.0], [5.0, 5.0]]])
    labels = np.array([[1, 0], [1, 1]])
    masks, iou, low = ours.predict_batched(coords, labels)
    r_logits, r_iou, r_low = ref.predict_batched(coords, labels, return_logits=True)
    assert masks.shape == (2, 3, 48, 64)
    np.testing.assert_allclose(low, r_low, **TOL)
    np.testing.assert_allclose(iou, r_iou, **TOL)
    _same_masks(masks, r_logits)


def test_predict_before_set_image_raises():
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL, device="cpu"), device="cpu")
    with pytest.raises(RuntimeError):
        SamPredictor(sam).predict(point_coords=np.zeros((1, 2)), point_labels=np.ones(1))


def test_sam_params_round_trip_through_jax():
    """A reference-layout state dict -> the JAX package's
    ``convert_torch_state_dict`` -> the port's ``params_from_jax`` gives
    back every key and value of the port's ``Sam`` with an encoder."""
    state = small_sam_state(1)
    back = params_from_jax(convert_torch_state_dict(state, depth=SMALL["depth"]))
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
