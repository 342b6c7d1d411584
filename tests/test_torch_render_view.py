"""``SamNerfRenderer.render_view`` (3D prompt locking) and its geometry
helpers, the port against the JAX package on the CPU.

The helpers run the same numpy arithmetic in both packages, so they must
agree exactly.  The view sequence renders the tiny 64x64 model of
``test_torch_serve_slice.py`` (same numpy-drawn weights, converted) through
both renderers with a SAM predictor over the same decoder: a click in view
0, a moved camera with a second click, then ``points=None``, which clears
the locked points; and a call with a crop box.  Tolerances: depth rtol
1e-4 (float32 sums in another order through proposal sampling); rgb and
the feature grids atol 1e-4, as ``test_torch_serve_slice.py``; locked 3D
points atol 1e-4 (depth error times a unit ray); projected pins and their
visibility exactly equal; the decoded masks agree on >= 99.9 % of pixels
(a logit near 0 may flip) and ``masked_rgb`` within 1e-4 where they agree.
"""
import dataclasses

import numpy as np
import pytest
import torch

from samnerf_tpu.engine import render_pipeline as jrp
from samnerf_tpu.models.sam_model import SAMModel as JaxModel
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu.perception.sam.predictor import SamPredictor as JaxPredictor
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.cameras import generate_rays
from samnerf_tpu_torch.engine import render_pipeline as trp
from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam
from samnerf_tpu_torch.utils.synthetic import look_at_c2w

from samnerf_tpu.perception import langsam as jls
from samnerf_tpu_torch.perception import langsam as tls

from test_model import TINY
from test_torch_clipseg import tiny_predictors
from test_torch_convert import decoder_state
from test_torch_langsam import (HEAT_TOL, MARGIN, check_top_cells_apart, record_predict,
                                sam_predictors, seeded_default_rng)
from test_torch_serve_slice import _model_params

H = W = 64
INTRIN = np.array([[40.0, 0.0, 32.0], [0.0, 40.0, 32.0], [0.0, 0.0, 1.0]])
# generic positions: the visibility test divides by ray direction per axis
VIEWS = [look_at_c2w(np.array(p), np.zeros(3)) for p in
         ((0.6, 0.45, 0.5), (0.5, 0.6, 0.45))]
GRID_TOL = dict(rtol=0, atol=1e-4)
CLICKS = [np.array([[20.0, 37.0]]), np.array([[20.0, 37.0], [41.0, 25.0]]), None]


# --- geometry -----------------------------------------------------------------------


def _geometry_inputs(seed=0):
    rng = np.random.default_rng(seed)
    c2w = look_at_c2w(rng.uniform(0.4, 1.0, 3), rng.uniform(-0.1, 0.1, 3))
    pts2d = np.stack([rng.integers(0, W, 12), rng.integers(0, H, 12)], -1).astype(np.float64)
    depth = rng.uniform(0.5, 2.0, (H, W, 1))
    return c2w, pts2d, depth


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_backproject_and_project_match_jax(seed):
    c2w, pts2d, depth = _geometry_inputs(seed)
    p3d = trp.backproject(pts2d, depth, INTRIN, c2w[:3, :4])
    np.testing.assert_array_equal(p3d, jrp.backproject(pts2d, depth, INTRIN, c2w[:3, :4]))
    for m in (c2w, c2w[:3]):
        pins = trp.project(INTRIN, m, p3d)
        assert pins.dtype == np.int32
        np.testing.assert_array_equal(pins, jrp.project(INTRIN, m, p3d))


@pytest.mark.parametrize("t_reduce", ("min", "mean"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_visible_mask_matches_jax(seed, t_reduce):
    c2w, pts2d, depth = _geometry_inputs(seed)
    p3d = trp.backproject(pts2d, depth, INTRIN, c2w[:3, :4])
    # half the points pushed behind the surface
    p3d[::2] += 0.5 * (p3d[::2] - c2w[:3, 3])
    vis = trp.visible_mask(pts2d, p3d, depth, INTRIN, c2w, t_reduce)
    np.testing.assert_array_equal(vis, jrp.visible_mask(pts2d, p3d, depth, INTRIN, c2w,
                                                        t_reduce))
    assert vis.any() and not vis.all()


def test_pooled_heatmap_points_and_draw_pins_match_jax():
    rng = np.random.default_rng(3)
    heat = rng.uniform(0.0, 0.75, (128, 96)).astype(np.float32)
    heat[32:64, 16:48] = 0.9
    for h in (heat, np.zeros_like(heat)):
        a, b = trp.pooled_heatmap_points(h, (240, 180)), jrp.pooled_heatmap_points(h, (240, 180))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    img = rng.uniform(size=(48, 40, 3)).astype(np.float32)
    pins = np.array([[5, 6], [39, 0], [20, 47], [-2, 3]])
    out = trp.draw_pins(img, pins, radius=3)
    np.testing.assert_array_equal(out, jrp.draw_pins(img, pins, radius=3))
    assert not np.array_equal(out, img)


# --- render_view --------------------------------------------------------------------


@pytest.fixture(scope="module")
def renderers():
    """(JAX renderer, its params, port renderer) over the same weights,
    each with a SAM predictor over the same decoder."""
    cfg = dataclasses.replace(TINY, hash_fn="morton")
    params = _model_params(cfg)
    dec_sd = decoder_state(3, for_masks=True)
    jsam, _ = build_sam("vit_b")
    jpred = JaxPredictor(jsam, {"params": convert_torch_state_dict(dec_sd, depth=12)})
    jsnr = jrp.SamNerfRenderer(JaxModel(cfg), sam_predictor=jpred, chunk=1024,
                               serve_preset="static")
    model = SAMModel(SAMModelConfig(**{f: getattr(cfg, f) for f in
                                       SAMModelConfig.__dataclass_fields__}),
                     device="cpu")
    model.load_state_dict(params_from_jax(params))
    sam = Sam(device="cpu")
    sam.load_state_dict(dec_sd)
    snr = trp.SamNerfRenderer(model, sam_predictor=SamPredictor(sam), chunk=1024,
                              serve_preset="static")
    return jsnr, params, snr


def _view(renderers, c2w, points, text_prompt=None, **crop):
    jsnr, params, snr = renderers
    jcams = jrp.cameras_from_intrin_c2w(INTRIN, c2w, H, W)
    ref = jsnr.render_view(params, jcams, 0, INTRIN, c2w, points=points,
                           text_prompt=text_prompt, width=W, height=H, **crop)
    cams = trp.cameras_from_intrin_c2w(INTRIN, c2w, H, W, device="cpu")
    out = snr.render_view(cams, 0, INTRIN, c2w, points=points, text_prompt=text_prompt,
                          width=W, height=H,
                          **{k: None if v is None else np.asarray(v) for k, v in crop.items()})
    return ref, out


def _masks(renderer, pins):
    masks, _, _ = renderer.predictor.predict(point_coords=pins.astype(np.float64),
                                             point_labels=np.ones(len(pins), np.int64),
                                             multimask_output=False)
    return masks[0]


def _check_view(renderers, c2w, ref, out):
    jsnr, _, snr = renderers
    for k, tol in (("depth", dict(rtol=1e-4, atol=1e-6)),
                   ("accumulation", dict(rtol=1e-4, atol=1e-6)),
                   ("rgb", GRID_TOL), ("sam", GRID_TOL), ("clipseg", GRID_TOL)):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), err_msg=k, **tol)
    assert (snr.prompts is None) == (jsnr.prompts is None)
    if snr.prompts is None:
        np.testing.assert_array_equal(out["masked_rgb"], out["rgb"])
        return None
    np.testing.assert_allclose(snr.prompts, jsnr.prompts, rtol=0, atol=1e-4)
    pins = trp.project(INTRIN, c2w, snr.prompts)
    np.testing.assert_array_equal(pins, jrp.project(INTRIN, c2w, jsnr.prompts))
    legal = ((pins >= 0) & (pins < np.array([[W, H]]))).all(-1)
    pins = pins[legal]
    vis = trp.visible_mask(pins.astype(np.float64), snr.prompts[legal], out["depth"],
                           INTRIN, c2w)
    np.testing.assert_array_equal(vis, jrp.visible_mask(
        pins.astype(np.float64), jsnr.prompts[legal], np.asarray(ref["depth"]), INTRIN, c2w))
    mask, jmask = _masks(snr, pins), _masks(jsnr, pins)
    same = mask == jmask
    assert same.mean() >= 0.999
    np.testing.assert_allclose(out["masked_rgb"][same], np.asarray(ref["masked_rgb"])[same],
                               rtol=0, atol=1e-4)
    # every visible pin is drawn: its pixel carries the pin color
    for x, y in pins[vis]:
        np.testing.assert_array_equal(out["masked_rgb"][y, x], [1.0, 0.0, 0.0])
    return mask, vis


def test_render_view_sequence_matches_jax(renderers):
    """A click locks a point, a moved camera re-draws it beside a second
    click, and ``points=None`` clears them."""
    masks = []
    for c2w, points in zip((VIEWS[0], VIEWS[1], VIEWS[1]), CLICKS):
        ref, out = _view(renderers, c2w, points)
        masks.append(_check_view(renderers, c2w, ref, out))
    (m0, v0), (m1, v1), cleared = masks
    assert renderers[2].prompts is None and cleared is None
    assert v0.all() and len(v1) == 2
    # the first click decodes a real mask, not an all-or-nothing one
    assert 0.01 < m0.mean() < 0.99


def test_render_view_crop_box_matches_jax(renderers):
    """A crop box around the camera: every ray starts inside it (near 0)
    and ends where it leaves the box, and the background shows where the
    box cuts the scene off.  (A ray that misses a box gets an empty
    interval far away, where both packages render rounding noise; the
    port follows the reference there, and the test keeps clear of it.)"""
    crop = dict(crop_aabb=[[-0.3, -0.25, -0.3], [0.8, 0.7, 0.7]], crop_bg=[0.2, 0.4, 0.6])
    cams = trp.cameras_from_intrin_c2w(INTRIN, VIEWS[0], H, W, device="cpu")
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rb = generate_rays(cams, torch.zeros(H * W, dtype=torch.long),
                       torch.from_numpy(np.stack([yy, xx], -1).reshape(-1, 2)),
                       aabb_box=torch.tensor(crop["crop_aabb"]))
    assert (rb.nears == 0).all() and (rb.fars > 0.1).all() and (rb.fars < 2.0).all()
    ref, out = _view(renderers, VIEWS[0], CLICKS[0], **crop)
    _check_view(renderers, VIEWS[0], ref, out)
    plain, _ = _view(renderers, VIEWS[0], CLICKS[0])
    assert np.abs(out["rgb"] - np.asarray(plain["rgb"])).max() > 0.05
    renderers[2].clear_prompts()
    renderers[0].clear_prompts()


# --- the text and no-distill branches -----------------------------------------------


def _same_points(a, b):
    """Point prompts equal up to their order (cells of equal rank may come
    in either order; the decoder's output does not depend on it)."""
    np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])


def test_render_view_text_prompt_matches_jax(renderers, tmp_path, monkeypatch):
    """A click and a text prompt on the distilling model: the ClipSeg
    heatmap of the prompt decoded on the rendered ClipSeg grid, its
    pooled cells above 0.7 as extra points after the locked one."""
    jsnr, _, snr = renderers
    jclip, tclip = tiny_predictors(tmp_path, logit_shift=0.8, flat_trans_conv=True)
    monkeypatch.setattr(jsnr, "clipseg", jclip)
    monkeypatch.setattr(snr, "clipseg", tclip)
    ref_calls = record_predict(monkeypatch, jsnr.predictor)
    calls = record_predict(monkeypatch, snr.predictor)
    try:
        ref, out = _view(renderers, VIEWS[0], CLICKS[0], text_prompt="a photo of a ball")
        pin = trp.project(INTRIN, VIEWS[0], snr.prompts)[0]
    finally:
        snr.clear_prompts()
        jsnr.clear_prompts()
    np.testing.assert_allclose(out["clipseg"], np.asarray(ref["clipseg"]), **GRID_TOL)
    heat = out["clipseg_feature"]
    assert heat.shape == (512, 512, 1) and heat.min() >= 0.0 and heat.max() <= 1.0
    np.testing.assert_allclose(heat, ref["clipseg_feature"], rtol=0, atol=HEAT_TOL)
    pooled = heat[..., 0].reshape(32, 16, 32, 16).mean(axis=(1, 3))
    assert np.abs(pooled - 0.7).min() > MARGIN      # before the points
    n_text = int((pooled > 0.7).sum())
    assert 0 < n_text < pooled.size
    (pts, mask), = calls
    (ref_pts, ref_mask), = ref_calls
    assert pts.shape == (1 + n_text, 2)
    np.testing.assert_array_equal(pts[0], pin)
    _same_points(pts, ref_pts)
    same = mask[0] == ref_mask[0]
    assert same.mean() >= 0.999
    np.testing.assert_allclose(out["masked_rgb"][same], np.asarray(ref["masked_rgb"])[same],
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def no_distill_renderers(tmp_path_factory):
    """(JAX renderer, its params, port renderer) of a model that distills
    nothing, each with a LanguageSAM over the small SAM and tiny ClipSeg."""
    cfg = dataclasses.replace(TINY, hash_fn="morton", distill_sam=False,
                              use_clipseg_feature=False)
    params = _model_params(cfg)
    jclip, tclip = tiny_predictors(tmp_path_factory.mktemp("no_distill"), logit_shift=0.3,
                                   flat_trans_conv=True)
    jpred, tpred = sam_predictors()
    jsnr = jrp.SamNerfRenderer(JaxModel(cfg), lang_sam=jls.LanguageSAM(jpred, jclip),
                               chunk=1024, serve_preset="static")
    model = SAMModel(SAMModelConfig(**{f: getattr(cfg, f) for f in
                                       SAMModelConfig.__dataclass_fields__}),
                     device="cpu")
    model.load_state_dict(params_from_jax(params))
    snr = trp.SamNerfRenderer(model, lang_sam=tls.LanguageSAM(tpred, tclip), chunk=1024,
                              serve_preset="static")
    return jsnr, params, snr


def test_render_view_no_distill_matches_jax(no_distill_renderers, monkeypatch):
    """A click, then a moved camera with the click locked and a text
    prompt: LanguageSAM on the rendered rgb with ``topk`` heatmap points
    above ``thresh`` and the projected locked point.

    The rendered rgb agrees to 1e-4, but its uint8 copy may then differ by
    one step at a pixel whose value lies that close to a rounding edge,
    and the tiny CLIP's global attention carries one such step into every
    heatmap pixel (1.6e-3 at the second view).  So the two ``render_view``
    calls are held to each other at that level, and the branch itself is
    held at the tolerances of ``test_torch_langsam.py`` against JAX's
    ``LanguageSAM`` given the port's own uint8 render and projected pin."""
    seeded_default_rng(monkeypatch)
    jsnr, _, snr = no_distill_renderers
    ref_calls = record_predict(monkeypatch, jsnr.lang_sam.predictor)
    calls = record_predict(monkeypatch, snr.lang_sam.predictor)
    for c2w, prompt in ((VIEWS[0], None), (VIEWS[1], "a photo of a ball")):
        ref, out = _view(no_distill_renderers, c2w, CLICKS[0], text_prompt=prompt)
        for k, tol in (("depth", dict(rtol=1e-4, atol=1e-6)), ("rgb", GRID_TOL)):
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), err_msg=k, **tol)
        assert "sam" not in out and "clipseg" not in out
        np.testing.assert_allclose(snr.prompts, jsnr.prompts, rtol=0, atol=1e-4)
        img = (out["rgb"] * 255).astype(np.uint8)
        np.testing.assert_array_equal(snr.lang_sam.image, img)
        steps = np.abs(img.astype(int) - jsnr.lang_sam.image.astype(int))
        assert steps.max() <= 1 and (steps == 0).mean() >= 0.999
        heat = out["clipseg_feature"]
        assert heat.shape == (512, 512, 1)
        np.testing.assert_allclose(heat, ref["clipseg_feature"], rtol=0, atol=5e-3)

        pins = trp.project(INTRIN, c2w, snr.prompts)
        ref_masked = jsnr.lang_sam.set_and_segment(
            img, prompt or "a man is cooking", pts=5, thres=0.5, points=pins.astype(np.float64))
        np.testing.assert_allclose(heat[..., 0], jsnr.lang_sam.clipseg_feature, rtol=0,
                                   atol=HEAT_TOL)
        n_heat = check_top_cells_apart(heat[..., 0], 5, 0.5)     # before the points
        pts, mask = calls[-1]
        ref_pts, ref_mask = ref_calls[-1]
        assert pts.shape == (min(5, n_heat) + 1, 2)
        np.testing.assert_array_equal(pts[-1], pins[0])
        np.testing.assert_array_equal(pts, ref_pts)
        same = mask[0] == ref_mask[0]        # (test_torch_langsam.py decodes a real mask)
        assert same.mean() >= 0.999
        np.testing.assert_allclose(out["masked_rgb"][same], ref_masked[same], rtol=0, atol=1e-4)
    assert len(calls) == 2 and len(ref_calls) == 4
    snr.clear_prompts()
    jsnr.clear_prompts()
