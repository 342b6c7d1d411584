"""The port's automatic mask generator (``perception/sam/amg.py`` and
``automatic_mask_generator.py``) against the JAX package's on the CPU.

- Every ``amg`` function on seeded cases, held to exact equality (both
  are numpy with the same arithmetic; the port labels connected
  components with ``scipy.ndimage.label`` in place of the JAX package's
  flood fill, and must give the same ``remove_small_regions``).
- ``generate`` on the small SAM of ``test_torch_predictor.py`` (random
  weights: its masks are large blobs, so box NMS is off to keep more than
  one), through ``set_feature`` (a rendered embedding, with small-region
  cleanup) and through ``set_image``, with a prompt batch that leaves a
  ragged tail (the JAX package pads it; the port does not): the same
  number of annotations, the same RLEs, areas, boxes, points and crop
  boxes, and predicted IoU and stability score at rtol 1e-5.
- With a crop layer (5 crops), each crop's masks against the JAX
  package's ``_process_crop``, and ``generate`` against those crops
  joined and de-duplicated.  The JAX ``generate`` itself fails there: a
  crop that keeps no mask gives a 1-D crop-box array, which does not
  concatenate with the other crops' [n, 4] (ROADMAP Queue C).
A mask pixel or a stability count flips when a logit sits within float
noise of the threshold or of threshold +- offset, so each case first
checks a margin: every logit the port decodes is at least 1e-4 from each
of them (the image and feature seeds are ones that keep it).
"""
import numpy as np
import pytest

from samnerf_tpu.perception.sam import amg as jamg
from samnerf_tpu.perception.sam.automatic_mask_generator import \
    SamAutomaticMaskGenerator as JaxGenerator
from samnerf_tpu_torch.perception.sam import amg
from samnerf_tpu_torch.perception.sam.automatic_mask_generator import \
    SamAutomaticMaskGenerator

from test_torch_predictor import predictors  # noqa: F401  (the fixture)

MARGIN = 1e-4


def _masks(seed, n=6, h=20, w=24, p=0.5):
    return np.random.default_rng(seed).random((n, h, w)) < p


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_rle_area_and_boxes_match_jax():
    masks = _masks(0)
    masks[1] = False                                    # empty
    masks[2] = True                                     # full, starts with a 1
    masks[3, :, :5] = masks[3, :, -3:] = False
    for m in masks:
        rle = amg.mask_to_rle(m)
        _same(rle, jamg.mask_to_rle(m))
        _same(amg.rle_to_mask(rle), jamg.rle_to_mask(rle))
        np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
        assert amg.area_from_rle(rle) == jamg.area_from_rle(rle) == int(m.sum())
    _same(amg.batched_mask_to_box(masks), jamg.batched_mask_to_box(masks))
    _same(amg.batched_mask_to_box(masks.reshape(2, 3, 20, 24)),
          jamg.batched_mask_to_box(masks.reshape(2, 3, 20, 24)))
    _same(amg.batched_mask_to_box(masks[:0]), jamg.batched_mask_to_box(masks[:0]))
    box = np.array([3.0, 4.0, 10.0, 12.0])
    _same(amg.box_xyxy_to_xywh(box), jamg.box_xyxy_to_xywh(box))


def test_stability_score_matches_jax():
    logits = np.random.default_rng(1).normal(0.0, 3.0, (5, 16, 16)).astype(np.float32)
    for thr, off in ((0.0, 1.0), (0.5, 0.25)):
        _same(amg.calculate_stability_score(logits, thr, off),
              jamg.calculate_stability_score(logits, thr, off))


@pytest.mark.parametrize("n_layers,scale", [(0, 1), (1, 1), (2, 2)])
def test_point_grids_and_crop_boxes_match_jax(n_layers, scale):
    _same(amg.build_point_grid(5), jamg.build_point_grid(5))
    _same(amg.build_all_layer_point_grids(8, n_layers, scale),
          jamg.build_all_layer_point_grids(8, n_layers, scale))
    for size in ((100, 150), (512, 512), (63, 40)):
        _same(amg.generate_crop_boxes(size, n_layers, 512 / 1500),
              jamg.generate_crop_boxes(size, n_layers, 512 / 1500))


def test_uncrop_and_crop_edge_match_jax():
    rng = np.random.default_rng(2)
    boxes = rng.integers(0, 40, (7, 4)).astype(np.int64)
    boxes[:, 2:] += boxes[:, :2]
    points = rng.random((7, 2)) * 30
    for crop in ([0, 0, 64, 48], [10, 6, 50, 40], [30, 20, 64, 48]):
        _same(amg.uncrop_boxes_xyxy(boxes, crop), jamg.uncrop_boxes_xyxy(boxes, crop))
        _same(amg.uncrop_points(points, crop), jamg.uncrop_points(points, crop))
        _same(amg.is_box_near_crop_edge(boxes, crop, [0, 0, 64, 48]),
              jamg.is_box_near_crop_edge(boxes, crop, [0, 0, 64, 48]))
        m = _masks(3, 2, crop[3] - crop[1], crop[2] - crop[0])
        _same(amg.uncrop_masks(m, crop, 48, 64), jamg.uncrop_masks(m, crop, 48, 64))
    _same(list(amg.batch_iterator(3, np.arange(7), np.arange(7.0))),
          list(jamg.batch_iterator(3, np.arange(7), np.arange(7.0))))


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("seed,p", [(4, 0.5), (5, 0.7), (6, 0.3)])
def test_remove_small_regions_matches_jax(mode, seed, p):
    mask = _masks(seed, 1, 40, 48, p)[0]
    for area in (1, 3, 10, 10_000):
        ours, changed = amg.remove_small_regions(mask, area, mode)
        ref, ref_changed = jamg.remove_small_regions(mask, area, mode)
        assert changed == ref_changed
        _same(ours, ref)
    labels, n = amg._connected_components(mask)
    ref_labels, ref_n = jamg._connected_components(mask)
    assert n == ref_n
    _same(labels, ref_labels)


def test_nms_and_mask_data_match_jax():
    rng = np.random.default_rng(7)
    xy = rng.integers(0, 30, (40, 2))
    boxes = np.concatenate([xy, xy + rng.integers(1, 20, (40, 2))], 1).astype(np.float32)
    scores = np.round(rng.random(40), 1)                # many ties
    for thr in (0.0, 0.3, 0.7, 1.0):
        _same(amg.nms(boxes, scores, thr), jamg.nms(boxes, scores, thr))
    stats = dict(a=np.arange(5.0), b=[f"r{i}" for i in range(5)], c=None)
    ours, ref = amg.MaskData(**stats), jamg.MaskData(**stats)
    for d in (ours, ref):
        d.filter(np.array([True, False, True, True, False]))
        d.cat(type(d)(a=np.array([9.0]), b=["x"]))
        d.filter(np.array([3, 0]))
        d.cat(type(d)(c=np.ones((2, 2))))
    _same(dict(ours.items()), dict(ref.items()))


IMAGE = np.random.default_rng(11).integers(0, 256, (32, 64, 3), dtype=np.uint8)
FEATURE = np.random.default_rng(111).normal(size=(2, 4, 256)).astype(np.float32)
GEN = dict(points_per_side=3, points_per_batch=4, pred_iou_thresh=0.0,
           stability_score_thresh=0.3, box_nms_thresh=1.0)


def _recorded(predictor):
    """Patch ``predict_batched`` to keep every logit it returns."""
    logits = []
    decode = predictor.predict_batched

    def record(*a, **k):
        out = decode(*a, **k)
        logits.append(out[0])
        return out

    predictor.predict_batched = record
    return logits


def _check_margin(logits, offset=1.0):
    flat = np.concatenate([x.reshape(-1) for x in logits])
    margin = min(np.abs(flat - t).min() for t in (0.0, offset, -offset))
    assert margin >= MARGIN, f"a logit lies {margin:.2e} from a threshold"


def _same_annotations(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in ("segmentation", "area", "bbox", "point_coords", "crop_box"):
            _same(a[k], b[k])
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("path", ["feature", "image"])
def test_generate_matches_jax(predictors, path):
    ours_pred, ref_pred = predictors
    kw = dict(GEN, min_mask_region_area=12, output_mode="uncompressed_rle") \
        if path == "feature" else GEN
    feature = FEATURE if path == "feature" else None
    logits = _recorded(ours_pred)
    try:
        ours = SamAutomaticMaskGenerator(ours_pred, **kw).generate(IMAGE, feature)
    finally:
        del ours_pred.predict_batched
    _check_margin(logits)
    assert len(logits) == 3                              # 9 points: 4 + 4 + 1
    ref = JaxGenerator(ref_pred, **kw).generate(IMAGE, feature)
    assert len(ours) > 1
    _same_annotations(ours, ref)


def test_generate_with_crops_matches_the_jax_crops(predictors):
    """Four points a crop (in batches of 3 and 1) keep the margin over the
    five crops' logits."""
    ours_pred, ref_pred = predictors
    kw = dict(GEN, points_per_side=2, points_per_batch=3, crop_n_layers=1)
    image = np.random.default_rng(0).integers(0, 256, (32, 64, 3), dtype=np.uint8)
    ours_gen = SamAutomaticMaskGenerator(ours_pred, **kw)
    ref_gen = JaxGenerator(ref_pred, **kw)
    boxes, layers = amg.generate_crop_boxes((32, 64), 1, ours_gen.crop_overlap_ratio)
    assert len(boxes) == 5
    logits = _recorded(ours_pred)
    try:
        anns = ours_gen.generate(image)
        crops = [ours_gen._process_crop(image, None, b, i, (32, 64))
                 for b, i in zip(boxes, layers)]
    finally:
        del ours_pred.predict_batched
    _check_margin(logits)
    joined = jamg.MaskData()
    for crop, box, layer in zip(crops, boxes, layers):
        ref = ref_gen._process_crop(image, None, box, layer, (32, 64))
        assert len(ref["rles"]) == len(crop["rles"])
        if not len(ref["rles"]):                 # the JAX package's 1-D crop boxes
            ref["crop_boxes"] = ref["crop_boxes"].reshape(-1, 4)
        _same({k: v for k, v in crop.items() if k not in ("iou_preds", "stability_score")},
              {k: v for k, v in ref.items() if k not in ("iou_preds", "stability_score")})
        for k in ("iou_preds", "stability_score"):
            np.testing.assert_allclose(crop[k], ref[k], rtol=1e-5, err_msg=k)
        joined.cat(ref)
    assert any(len(c["rles"]) == 0 for c in crops) and sum(len(c["rles"]) for c in crops)
    # the JAX package's cross-crop NMS on its own crops
    cb = joined["crop_boxes"]
    keep = jamg.nms(joined["boxes"].astype(np.float32),
                    1.0 / np.maximum((cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1]), 1),
                    ref_gen.crop_nms_thresh)
    joined.filter(keep)
    assert [a["segmentation"].tolist() for a in anns] == \
        [jamg.rle_to_mask(r).tolist() for r in joined["rles"]]
    assert [a["crop_box"] for a in anns] == \
        [jamg.box_xyxy_to_xywh(b).tolist() for b in joined["crop_boxes"]]
