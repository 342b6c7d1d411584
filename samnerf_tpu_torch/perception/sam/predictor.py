"""Stateful SamPredictor: set_image / set_feature / predict, counterpart of
``samnerf_tpu/perception/sam/predictor.py``.

``set_feature`` is the distillation hook: it takes an embedding rendered
by the NeRF (zero-padding a rectangular map to the square grid) in place
of running the ViT.  The port runs eagerly, so a prompt of n points goes
to the prompt encoder as exactly n points, to which it adds the
reference's one not-a-point pad; the JAX package pads to static buckets
and masks the padding instead, which gives the same masks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.perception.sam.sam import Sam, postprocess_masks
from samnerf_tpu_torch.perception.sam.transforms import ResizeLongestSide


class SamPredictor:
    def __init__(self, sam_model: Sam) -> None:
        self.model = sam_model
        self.transform = ResizeLongestSide(sam_model.img_size)
        self.device = sam_model.mask_decoder.iou_token.weight.device
        self.reset_image()

    def reset_image(self) -> None:
        self.is_image_set = False
        self.features = None
        self.original_size = None
        self.input_size = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """image: HWC uint8.  Runs the image encoder."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format must be RGB or BGR, got {image_format!r}")
        if image_format == "BGR":
            image = image[..., ::-1]
        input_image = self.transform.apply_image(np.ascontiguousarray(image))
        self.original_size = tuple(image.shape[:2])
        self.input_size = tuple(input_image.shape[:2])
        x = torch.from_numpy(np.array(input_image)).to(self.device, torch.float32)[None]
        self.features = self.model.encode_image(self.model.preprocess(x))
        self.is_image_set = True

    def set_feature(self, feature, original_image_size: Tuple[int, int]) -> None:
        """A rendered embedding [h, w, 256] (h or w == the grid size), NHWC
        (the reference takes CHW)."""
        self.reset_image()
        self.original_size = tuple(original_image_size)
        h, w = self.original_size
        img_size = self.model.img_size
        if h <= w:
            self.input_size = (int(math.ceil(h / w * img_size)), img_size)
        else:
            self.input_size = (img_size, int(math.ceil(w / h * img_size)))
        feature = torch.as_tensor(feature, dtype=torch.float32, device=self.device)
        fh, fw, _ = feature.shape
        side = max(fh, fw)
        self.features = torch.nn.functional.pad(
            feature, (0, 0, 0, side - fw, 0, side - fh))[None]
        self.is_image_set = True

    def _decode(self, points, boxes, mask_in, multimask_output, return_logits):
        low_res, iou = self.model.decode_masks(self.features, points, boxes,
                                               mask_in, multimask_output)
        masks = postprocess_masks(low_res, self.input_size, self.original_size,
                                  self.model.img_size)
        if not return_logits:
            masks = masks > self.model.mask_threshold
        return masks.cpu().numpy(), iou.cpu().numpy(), low_res.cpu().numpy()

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False):
        """numpy in and out: (masks [C, H, W] at the original size, iou
        [C], low-res logits [C, 4e, 4e])."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) "
                               "before mask prediction.")
        points = boxes = mask_in = None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels must be given with point_coords")
            pc = self.transform.apply_coords(point_coords, self.original_size)
            points = (torch.as_tensor(pc, dtype=torch.float32, device=self.device)[None],
                      torch.as_tensor(np.asarray(point_labels), dtype=torch.int64,
                                      device=self.device)[None])
        if box is not None:
            boxes = torch.as_tensor(self.transform.apply_boxes(box, self.original_size),
                                    dtype=torch.float32, device=self.device)
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            mask_in = torch.as_tensor(m.reshape(1, *m.shape[-2:], 1), device=self.device)
        masks, iou, low_res = self._decode(points, boxes, mask_in, multimask_output,
                                           return_logits)
        return masks[0], iou[0], low_res[0]

    @torch.no_grad()
    def predict_batched(self, point_coords: np.ndarray, point_labels: np.ndarray,
                        multimask_output: bool = True, return_logits: bool = False):
        """B independent prompt sets at once: coords [B, N, 2] already in
        the input frame, labels [B, N] -> (masks [B, C, H, W], iou [B, C],
        low-res [B, C, 4e, 4e]) as numpy."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set before mask prediction.")
        points = (torch.as_tensor(point_coords, dtype=torch.float32, device=self.device),
                  torch.as_tensor(point_labels, dtype=torch.int64, device=self.device))
        return self._decode(points, None, None, multimask_output, return_logits)

    def get_image_embedding(self) -> torch.Tensor:
        """[1, 64, 64, 256] NHWC."""
        if not self.is_image_set:
            raise RuntimeError("image not set")
        return self.features
