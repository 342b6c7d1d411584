"""ResizeLongestSide without torchvision, counterpart of
``samnerf_tpu/perception/sam/transforms.py``: images go through PIL
bilinear, as the reference's ``to_pil_image`` + ``resize`` does."""
from __future__ import annotations

from typing import Tuple

import numpy as np


class ResizeLongestSide:
    def __init__(self, target_length: int) -> None:
        self.target_length = target_length

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8 -> resized HWC uint8 (PIL bilinear)."""
        from PIL import Image
        newh, neww = self.get_preprocess_shape(image.shape[0], image.shape[1],
                                               self.target_length)
        return np.asarray(Image.fromarray(image).resize((neww, newh), Image.BILINEAR))

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, int]) -> np.ndarray:
        old_h, old_w = original_size
        new_h, new_w = self.get_preprocess_shape(old_h, old_w, self.target_length)
        coords = np.array(coords, dtype=float)
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords

    def apply_boxes(self, boxes: np.ndarray,
                    original_size: Tuple[int, int]) -> np.ndarray:
        return self.apply_coords(boxes.reshape(-1, 2, 2), original_size).reshape(-1, 4)

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int,
                             long_side_length: int) -> Tuple[int, int]:
        scale = long_side_length * 1.0 / max(oldh, oldw)
        return int(oldh * scale + 0.5), int(oldw * scale + 0.5)
