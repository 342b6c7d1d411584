"""AMG utilities: mask containers, RLE, stability score, point grids,
crop boxes, small-region removal, boxes around masks and NMS.

The port's copy of ``samnerf_tpu/perception/sam/amg.py``, all numpy and
the same arithmetic, so both packages give the same masks, boxes and
order (``nms`` orders with the same ``np.argsort(-scores)``, so ties
break the same way).  One change: the connected components of
:func:`remove_small_regions` come from ``scipy.ndimage.label`` (4-connected,
the same regions as the JAX package's Python flood fill, which is slow
on a 512x512 mask).
"""
from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Dict, Generator, List, Tuple

import numpy as np


class MaskData:
    """Dict of batched mask stats supporting filter / cat."""

    def __init__(self, **kwargs):
        self._stats: Dict[str, Any] = dict(kwargs)

    def __setitem__(self, key, item):
        self._stats[key] = item

    def __getitem__(self, key):
        return self._stats[key]

    def __delitem__(self, key):
        del self._stats[key]

    def __contains__(self, key):
        return key in self._stats

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]

    def cat(self, new_stats: "MaskData"):
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)


def is_box_near_crop_edge(boxes, crop_box, orig_box, atol=20.0):
    """Boxes [N, 4] (xyxy, crop frame) within ``atol`` of the crop's edge
    and not of the image's."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    near_crop = np.logical_and(near_crop, ~near_image)
    return np.any(near_crop, axis=1)


def box_xyxy_to_xywh(box):
    box = np.array(box, np.float32)
    box[2] = box[2] - box[0]
    box[3] = box[3] - box[1]
    return box


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    n = len(args[0])
    for b in range(int(math.ceil(n / batch_size))):
        yield [a[b * batch_size:(b + 1) * batch_size] for a in args]


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Column-major RLE of one [H, W] bool mask."""
    h, w = mask.shape
    flat = mask.T.reshape(-1)
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], diff, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """The [H, W] bool mask of a column-major RLE."""
    h, w = rle["size"]
    mask = np.empty(h * w, bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx:idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).T


def area_from_rle(rle) -> int:
    return sum(rle["counts"][1::2])


def calculate_stability_score(masks: np.ndarray, mask_threshold: float,
                              threshold_offset: float) -> np.ndarray:
    """IoU between the masks of logits above threshold +- offset."""
    high = (masks > (mask_threshold + threshold_offset)).sum(axis=(-1, -2),
                                                             dtype=np.int64)
    low = (masks > (mask_threshold - threshold_offset)).sum(axis=(-1, -2),
                                                            dtype=np.int64)
    return high / np.maximum(low, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Normalised [n^2, 2] (x, y) grid of cell centres."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(pts[None, :], (n_per_side, 1))
    py = np.tile(pts[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float):
    """Crop boxes (xyxy) of each layer and their layer indices."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                                   min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.array([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return points + np.array([[x0, y0]], points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box, orig_h: int,
                 orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1))
    return np.pad(masks, pad[-masks.ndim:])


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Fill holes or remove islands smaller than ``area_thresh``; returns
    (mask, changed)."""
    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, n = _connected_components(working)
    sizes = np.bincount(labels.reshape(-1), minlength=n + 1)
    # label 0 is the background
    small = [i for i in range(1, n + 1) if sizes[i] < area_thresh]
    if not small:
        return mask, False
    fill = np.isin(labels, small)
    mask = np.where(fill, correct_holes, mask)
    return mask.astype(bool), True


def _connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected labelling: labels [H, W] int32 (0 outside the mask) and
    the number of regions."""
    from scipy import ndimage
    labels, n = ndimage.label(mask)
    return labels.astype(np.int32), int(n)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """xyxy boxes around masks [..., H, W]; zeros for an empty mask."""
    if masks.size == 0:
        return np.zeros((*masks.shape[:-2], 4), np.int64)
    shape = masks.shape
    masks = masks.reshape(-1, *shape[-2:])
    in_h = masks.max(axis=-1)  # [B, H]
    in_w = masks.max(axis=-2)  # [B, W]
    h = masks.shape[-2]
    w = masks.shape[-1]
    ys = np.arange(h)
    xs = np.arange(w)
    top = np.where(in_h, ys[None], h)[...,].min(axis=-1)
    bottom = np.where(in_h, ys[None], -1).max(axis=-1)
    left = np.where(in_w, xs[None], w).min(axis=-1)
    right = np.where(in_w, xs[None], -1).max(axis=-1)
    empty = (bottom < top) | (right < left)
    boxes = np.stack([left, top, right + 1, bottom + 1], axis=-1)
    boxes[empty] = 0
    return boxes.reshape(*shape[:-2], 4)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
        ) -> np.ndarray:
    """Greedy IoU NMS: the kept indices, highest score first."""
    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0]) *
                  (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)
