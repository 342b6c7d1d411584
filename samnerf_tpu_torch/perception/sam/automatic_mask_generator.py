"""Everything-mode mask generation: a grid of point prompts per crop ->
filtered, de-duplicated masks.

The port's copy of ``samnerf_tpu/perception/sam/automatic_mask_generator.py``,
same defaults and the same steps, on the port's :class:`SamPredictor`:
``set_image`` per crop (the ViT encoder on the card), or ``set_feature``
with a rendered embedding (``feature=``) in its place.  The JAX package
pads the last prompt batch to ``points_per_batch`` for a fixed jit shape;
the port decodes the prompts there are, which gives the same masks.  An
empty crop keeps a [0, 4] crop-box array, so crops after it concatenate.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from samnerf_tpu_torch.perception.sam import amg
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor


class SamAutomaticMaskGenerator:
    def __init__(self, predictor: SamPredictor,
                 points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask"):
        assert (points_per_side is None) != (point_grids is None)
        if points_per_side is not None:
            self.point_grids = amg.build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        assert output_mode in ("binary_mask", "uncompressed_rle")
        self.predictor = predictor
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    def generate(self, image: np.ndarray,
                 feature: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
        """Annotations of every mask kept: ``segmentation`` (a bool [H, W]
        mask, or its RLE with ``output_mode="uncompressed_rle"``), ``area``,
        ``bbox`` and ``crop_box`` (xywh), ``predicted_iou``,
        ``point_coords``, ``stability_score``."""
        mask_data = self._generate_masks(image, feature)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh))
        if self.output_mode == "binary_mask":
            segmentations = [amg.rle_to_mask(r) for r in mask_data["rles"]]
        else:
            segmentations = mask_data["rles"]
        anns = []
        for i in range(len(segmentations)):
            anns.append({
                "segmentation": segmentations[i],
                "area": amg.area_from_rle(mask_data["rles"][i]),
                "bbox": amg.box_xyxy_to_xywh(mask_data["boxes"][i]).tolist(),
                "predicted_iou": float(mask_data["iou_preds"][i]),
                "point_coords": [mask_data["points"][i].tolist()],
                "stability_score": float(mask_data["stability_score"][i]),
                "crop_box": amg.box_xyxy_to_xywh(
                    mask_data["crop_boxes"][i]).tolist(),
            })
        return anns

    def _generate_masks(self, image, feature=None) -> amg.MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = amg.generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = amg.MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, feature, crop_box, layer_idx,
                                        orig_size))
        if len(crop_boxes) > 1:
            areas = ((data["crop_boxes"][:, 2] - data["crop_boxes"][:, 0]) *
                     (data["crop_boxes"][:, 3] - data["crop_boxes"][:, 1]))
            scores = 1.0 / np.maximum(areas, 1)
            keep = amg.nms(data["boxes"].astype(np.float32), scores,
                           self.crop_nms_thresh)
            data.filter(keep)
        return data

    def _process_crop(self, image, feature, crop_box, layer_idx,
                      orig_size) -> amg.MaskData:
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1, :]
        crop_size = cropped.shape[:2]
        if feature is not None:
            self.predictor.set_feature(feature, crop_size)
        else:
            self.predictor.set_image(cropped)
        points_scale = np.array(crop_size)[None, ::-1]
        points = self.point_grids[layer_idx] * points_scale

        data = amg.MaskData()
        for (batch_points,) in amg.batch_iterator(self.points_per_batch,
                                                  points):
            data.cat(self._process_batch(batch_points, crop_size, crop_box,
                                         orig_size))
        self.predictor.reset_image()

        keep = amg.nms(data["boxes"].astype(np.float32),
                       data["iou_preds"], self.box_nms_thresh)
        data.filter(keep)
        data["boxes"] = amg.uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = amg.uncrop_points(data["points"], crop_box)
        data["crop_boxes"] = np.array([crop_box] * len(data["rles"])).reshape(-1, 4)
        return data

    def _process_batch(self, points, im_size, crop_box,
                       orig_size) -> amg.MaskData:
        orig_h, orig_w = orig_size
        tp = self.predictor.transform.apply_coords(points, im_size)
        masks, iou_preds, _ = self.predictor.predict_batched(
            tp[:, None, :], np.ones((tp.shape[0], 1), np.int32),
            multimask_output=True, return_logits=True)

        k = masks.shape[1]
        data = amg.MaskData(
            masks=masks.reshape(-1, *masks.shape[-2:]),
            iou_preds=iou_preds.reshape(-1),
            points=np.repeat(points, k, axis=0))
        if self.pred_iou_thresh > 0.0:
            data.filter(data["iou_preds"] > self.pred_iou_thresh)
        data["stability_score"] = amg.calculate_stability_score(
            data["masks"], self.predictor.model.mask_threshold,
            self.stability_score_offset)
        if self.stability_score_thresh > 0.0:
            data.filter(data["stability_score"] >= self.stability_score_thresh)
        data["masks"] = data["masks"] > self.predictor.model.mask_threshold
        data["boxes"] = amg.batched_mask_to_box(data["masks"])
        keep = ~amg.is_box_near_crop_edge(data["boxes"], crop_box,
                                          [0, 0, orig_w, orig_h])
        if not np.all(keep):
            data.filter(keep)
        data["masks"] = amg.uncrop_masks(data["masks"], crop_box, orig_h,
                                         orig_w)
        data["rles"] = [amg.mask_to_rle(mk) for mk in data["masks"]]
        del data["masks"]
        return data

    @staticmethod
    def postprocess_small_regions(mask_data, min_area, nms_thresh):
        """Fill small holes and remove small islands of each mask, then
        NMS again, preferring the masks that needed no change."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = amg.rle_to_mask(rle)
            mask, changed = amg.remove_small_regions(mask, min_area, "holes")
            unchanged = not changed
            mask, changed = amg.remove_small_regions(mask, min_area, "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))  # prefer untouched masks
        masks = np.stack(new_masks)
        boxes = amg.batched_mask_to_box(masks)
        keep = amg.nms(boxes.astype(np.float32), np.asarray(scores),
                       nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                mask_data["rles"][i] = amg.mask_to_rle(masks[i])
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data
