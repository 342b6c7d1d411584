"""LanguageSAM: a text prompt -> a mask on one image, counterpart of
``samnerf_tpu/perception/langsam.py``.  ClipSeg's sigmoid heatmap of the
prompt, 16x16 average pooled, gives point prompts above a threshold (the
top ``point_num``), which SAM decodes into a mask on the image; the mask
is composited in a random color.  The overlays (``show_mask``,
``composite_mask``) are numpy only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def show_mask(mask: np.ndarray, rng: Optional[np.random.Generator] = None,
              random_color: bool = False) -> np.ndarray:
    """[h, w] bool -> RGBA overlay: a random color from ``rng`` or SAM's
    blue, at alpha 0.6."""
    if random_color:
        rng = rng or np.random.default_rng()
        color = np.concatenate([rng.random(3), [0.6]])
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255, 0.6])
    return mask[..., None] * color[None, None]


def composite_mask(mask: np.ndarray, image: np.ndarray,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Blend a random mask color over ``image`` [h, w, 3] in [0, 1]."""
    m = show_mask(mask, rng=rng, random_color=True)
    return m[..., :3] * m[..., 3:] + image * (1 - m[..., 3:])


def heatmap_to_points(heat: np.ndarray, image_hw: Tuple[int, int],
                      point_num: int = 5, threshold: float = 0.5,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sigmoid heatmap [H, W] -> point prompts [N, 2] (x, y) in image
    pixels: the 16x16-pooled cells above ``threshold``, the ``point_num``
    highest (or, for ``point_num`` <= 0, all but the last -point_num of a
    random order); [0, 2] when no cell passes."""
    h16, w16 = heat.shape[0] // 16, heat.shape[1] // 16
    pooled = heat.reshape(h16, 16, w16, 16).mean(axis=(1, 3))
    inds = np.argwhere(pooled > threshold)  # [M, 2] (row, col)
    if inds.shape[0] > 0:
        vals = pooled[inds[:, 0], inds[:, 1]]
        if point_num > 0:
            sel = np.argsort(-vals)[:min(point_num, vals.shape[0])]
        else:
            rng = rng or np.random.default_rng()
            sel = rng.permutation(vals.shape[0])[:-point_num]
        inds = inds[sel]
    pts = inds.astype(np.float64)
    pts[:, 0] = pts[:, 0] / pooled.shape[0] * image_hw[0]
    pts[:, 1] = pts[:, 1] / pooled.shape[1] * image_hw[1]
    return pts[:, ::-1].copy()  # (x, y)


class LanguageSAM:
    """A :class:`~samnerf_tpu_torch.perception.sam.predictor.SamPredictor`
    with an image encoder and a
    :class:`~samnerf_tpu_torch.perception.clipseg.pipeline.ClipSegPredictor`.
    ``clipseg_feature`` holds the last heatmap [H, W]."""

    def __init__(self, sam_predictor, clipseg):
        self.predictor = sam_predictor
        self.clipseg = clipseg
        self.image: Optional[np.ndarray] = None
        self.clipseg_feature: Optional[np.ndarray] = None

    def set_image(self, image: np.ndarray) -> None:
        """image HWC uint8; the encoder runs unless it is the last image."""
        if (self.image is not None and image.shape == self.image.shape
                and np.array_equal(image, self.image)):
            return
        self.image = image
        self.predictor.set_image(image)

    def get_mask_by_prompt(self, prompt: str, point_num: int = 5, threshold: float = 0.5,
                           points: Optional[np.ndarray] = None) -> np.ndarray:
        """The set image [h, w, 3] in [0, 1] with the prompt's mask
        composited, from the heatmap's points and ``points`` [N, 2] (x, y);
        the image alone when there is no point."""
        cond = self.clipseg.encode_text([prompt])
        heat = self.clipseg.segment(self.image, cond).cpu().numpy()
        heat = 1.0 / (1.0 + np.exp(-heat))
        self.clipseg_feature = heat
        pts = heatmap_to_points(heat, self.image.shape[:2], point_num=point_num,
                                threshold=threshold)
        if points is not None:
            pts = np.concatenate([pts, points], axis=0)
        if pts.shape[0] == 0:
            return self.image.astype(np.float32) / 255.0
        masks, _, _ = self.predictor.predict(point_coords=pts,
                                             point_labels=np.ones(pts.shape[0], np.int64),
                                             multimask_output=False)
        return composite_mask(masks[0], self.image.astype(np.float32) / 255.0)

    def set_and_segment(self, image: np.ndarray, prompt: str, pts: int = 5,
                        thres: float = 0.5, points: Optional[np.ndarray] = None) -> np.ndarray:
        self.set_image(image)
        return self.get_mask_by_prompt(prompt, point_num=pts, threshold=thres, points=points)
