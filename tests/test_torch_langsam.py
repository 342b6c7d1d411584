"""The port's ``heatmap_to_points`` and ``LanguageSAM`` against the JAX
package's on the CPU.

``heatmap_to_points`` runs the same numpy arithmetic in both packages, so
it must agree exactly, also when no cell passes the threshold and with a
seeded random order.  ``LanguageSAM.set_and_segment`` runs the small SAM
of ``test_torch_predictor.py`` (an image encoder, one reference-layout
state dict for both packages) and the tiny ClipSeg of
``test_torch_clipseg.py`` on one image with a locked point: the heatmaps
within atol 1e-5 (sigmoids of logits that agree to 1e-5), the point
prompts equal (after checking that the top cells' values keep more than
twice that apart and from the threshold, so none can swap places or
cross it), the masks on >= 99.9 % of pixels
and the composite within 1e-4 where they agree.  Both packages draw the
composite's color from ``np.random.default_rng()`` without a seed; the
test seeds that call the same way for both.
"""
import numpy as np
import pytest

from samnerf_tpu.perception import langsam as jls
from samnerf_tpu.perception.sam.predictor import SamPredictor as JaxPredictor
from samnerf_tpu.perception.sam.build_sam import convert_torch_state_dict
from samnerf_tpu_torch.perception import langsam as tls
from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam

from test_torch_clipseg import tiny_predictors
from test_torch_predictor import SMALL, jax_small_sam, small_sam_state

HEAT_TOL = 1e-5
MARGIN = 2 * HEAT_TOL   # pooled cells within HEAT_TOL of each other's could swap


@pytest.mark.parametrize("point_num", (5, 1, 40, 0, -3))
@pytest.mark.parametrize("case", ("peaked", "none", "rect"))
def test_heatmap_to_points_matches_jax(case, point_num):
    rng = np.random.default_rng(0)
    heat = rng.uniform(0.0, 0.6, (512, 512)).astype(np.float32)
    hw = (480, 640)
    if case == "peaked":
        heat[128:256, 64:192] += 0.35
    elif case == "none":
        heat *= 0.5
    else:
        heat = heat[:256, :384].copy()
        heat[16:80, 200:300] = 0.9
        hw = (300, 450)
    ours = tls.heatmap_to_points(heat, hw, point_num=point_num, threshold=0.5,
                                 rng=np.random.default_rng(7))
    ref = jls.heatmap_to_points(heat, hw, point_num=point_num, threshold=0.5,
                                rng=np.random.default_rng(7))
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)
    assert (len(ours) == 0) == (case == "none" or point_num == 0)   # [:-0] keeps none


def sam_predictors():
    """(JAX, port) predictors over the small SAM with its image encoder."""
    state = small_sam_state(0)
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL, device="cpu"), device="cpu")
    sam.load_state_dict(state)
    params = convert_torch_state_dict(state, depth=SMALL["depth"])
    return JaxPredictor(jax_small_sam(), {"params": params}), SamPredictor(sam)


def record_predict(monkeypatch, predictor):
    """Wrap ``predictor.predict`` (for the test) to keep each call's points
    and masks."""
    calls, predict = [], predictor.predict

    def wrapped(**kw):
        out = predict(**kw)
        calls.append((np.asarray(kw["point_coords"]), np.asarray(out[0])))
        return out

    monkeypatch.setattr(predictor, "predict", wrapped)
    return calls


def seeded_default_rng(monkeypatch):
    """``np.random.default_rng()`` without a seed -> seed 0, for both
    packages' composite colors."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(0 if seed is None else seed))


def check_top_cells_apart(heat, point_num, threshold):
    """The pooled cells that choose the points keep MARGIN from the
    threshold and from each other's ranks, so the packages cannot choose
    differently."""
    pooled = np.sort(heat.reshape(32, 16, 32, 16).mean(axis=(1, 3)).ravel())[::-1]
    top = pooled[:point_num + 1]
    assert np.abs(top - threshold).min() > MARGIN
    assert np.abs(np.diff(top)).min() > MARGIN
    return int((pooled > threshold).sum())


@pytest.fixture(scope="module")
def lang_sams(tmp_path_factory):
    jclip, tclip = tiny_predictors(tmp_path_factory.mktemp("langsam"))
    jpred, tpred = sam_predictors()
    return jls.LanguageSAM(jpred, jclip), tls.LanguageSAM(tpred, tclip)


def test_set_and_segment_matches_jax(lang_sams, monkeypatch):
    seeded_default_rng(monkeypatch)
    jlang, tlang = lang_sams
    ref_calls = record_predict(monkeypatch, jlang.predictor)
    calls = record_predict(monkeypatch, tlang.predictor)
    img = np.random.default_rng(5).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    locked = np.array([[30.0, 20.0]])
    ref = jlang.set_and_segment(img, "a photo of a dog", pts=5, thres=0.5, points=locked)
    out = tlang.set_and_segment(img, "a photo of a dog", pts=5, thres=0.5, points=locked)
    assert tlang.clipseg_feature.shape == (512, 512)
    np.testing.assert_allclose(tlang.clipseg_feature, jlang.clipseg_feature, rtol=0,
                               atol=HEAT_TOL)
    assert check_top_cells_apart(jlang.clipseg_feature, 5, 0.5) >= 5   # before the points
    (pts, mask), = calls
    (ref_pts, ref_mask), = ref_calls
    assert pts.shape == (6, 2)
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_array_equal(pts[-1], locked[0])
    same = mask[0] == ref_mask[0]
    assert same.mean() >= 0.999 and 0.0 < mask[0].mean() < 1.0
    assert out.shape == (48, 80, 3)
    np.testing.assert_allclose(out[same], np.asarray(ref)[same], rtol=0, atol=1e-4)


def test_set_image_runs_the_encoder_once_per_image(lang_sams, monkeypatch):
    _, tlang = lang_sams
    runs, set_image = [], tlang.predictor.set_image
    monkeypatch.setattr(tlang.predictor, "set_image",
                        lambda image: runs.append(image) or set_image(image))
    img = np.random.default_rng(6).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    tlang.set_image(img)
    tlang.set_image(img.copy())
    assert len(runs) == 1
    tlang.set_image(img[::-1].copy())
    assert len(runs) == 2


def test_no_point_returns_the_image(lang_sams):
    """A threshold no cell passes and no locked point: the image as it is."""
    _, tlang = lang_sams
    img = np.random.default_rng(8).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    out = tlang.set_and_segment(img, "a photo of a dog", pts=5, thres=1.0)
    np.testing.assert_array_equal(out, img.astype(np.float32) / 255.0)
