"""The interactive serve path: render a view, decode a SAM mask from a
click on the rendered embedding, composite the overlay.

Counterpart of ``samnerf_tpu/engine/render_pipeline.py`` (``serve_model``,
``SamNerfRenderer`` with ``serve_frame_fn`` and ``bake_serve_tables``).
``render_view`` with 3D prompt locking and ClipSeg text prompts waits.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.engine.eval_render import ImageRenderer
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.ops.hash_grid import bake_quantized_tables
from samnerf_tpu_torch.perception.sam.sam import Sam, postprocess_masks


def serve_model(model: SAMModel, nerf: int = 0, props: int = 0,
                k: int = 0) -> SAMModel:
    """``model`` with reduced sample counts.  Sample counts are config, not
    weights, so the returned model shares every submodule (and so every
    parameter and baked table) with ``model``; counts are only lowered."""
    cfg = model.config
    if nerf:
        cfg = dataclasses.replace(cfg, num_nerf_samples_per_ray=min(
            nerf, cfg.num_nerf_samples_per_ray))
    if props:
        cfg = dataclasses.replace(cfg, num_proposal_samples_per_ray=tuple(
            min(props, p) for p in cfg.num_proposal_samples_per_ray))
    if k or nerf:
        cfg = dataclasses.replace(cfg, num_sam_samples=min(
            k or cfg.num_sam_samples, cfg.num_sam_samples,
            cfg.num_nerf_samples_per_ray))
    served = copy.copy(model)       # shallow: the submodule dict is shared
    served.config = cfg
    return served


class SamNerfRenderer:
    """The viewer's serve backend over one model."""

    #: "static" trims the SAM-field top-k to 8; "move" also halves the nerf
    #: and proposal counts (the renderer for a moving camera).
    SERVE_PRESETS = {"full": dict(),
                     "static": dict(k=8),
                     "move": dict(nerf=16, props=32, k=2)}

    def __init__(self, model: SAMModel, chunk: int = 1 << 15,
                 serve_preset: str = "full"):
        model = serve_model(model, **self.SERVE_PRESETS[serve_preset])
        self.renderer = ImageRenderer(model, chunk=chunk)
        self.cfg = model.config
        self._move_renderer: Optional[ImageRenderer] = None
        if serve_preset == "static":
            self._move_renderer = ImageRenderer(
                serve_model(model, **self.SERVE_PRESETS["move"]), chunk=chunk)

    def _renderer_for(self, preset: str) -> ImageRenderer:
        if preset == "move" and self._move_renderer is not None:
            return self._move_renderer
        return self.renderer

    @torch.no_grad()
    def bake_serve_tables(self, optimize: int = 12) -> None:
        """Pre-quantize every hash table at int8 and int4 into the model's
        ``qtable{b}`` / ``qscales{b}`` buffers (with ``optimize``
        candidates of the MSE-optimal scale search; 0 = max scale), so
        frames skip the per-call quantization.  No-op unless the model
        serves quantized tables."""
        if not self.cfg.hash_q8_serve:
            return
        for enc in self.renderer.model.modules():
            if isinstance(enc, ParityHashEncoding):
                baked = bake_quantized_tables({"table": enc.table.detach()},
                                              optimize=optimize)
                for name, t in baked.items():
                    if name != "table":
                        setattr(enc, name, t)

    def serve_frame_fn(self, sam: Sam, height: int, width: int,
                       max_points: int = 4, preset: str = "primary"):
        """Returns ``serve(cameras, cam_idx, click_xy, return_mask=False)
        -> uint8 [H, W, 3]`` on the model's device: render rgb + SAM and
        ClipSeg grids, decode a mask from the click on the rendered SAM
        embedding, composite the red overlay."""
        H, W = height, width
        renderer = self._renderer_for(preset)
        cfg = self.cfg
        feats = (("sam", "clipseg") if cfg.distill_sam and cfg.use_clipseg_feature
                 else ("sam",) if cfg.distill_sam else ())

        @torch.no_grad()
        def serve(cameras: Cameras, cam_idx: int, click_xy,
                  return_mask: bool = False):
            device = cameras.camera_to_worlds.device
            frame = renderer.render_image_device(cameras, cam_idx, W, H,
                                                 features=feats, minimal=True)
            # click -> 1024-frame coords (ResizeLongestSide convention)
            scale = 1024.0 / max(H, W)
            pts = np.zeros((1, max_points, 2), np.float32)
            pts[0, 0] = [click_xy[0] * scale, click_xy[1] * scale]
            labels = np.full((1, max_points), -1, np.int64)
            labels[0, 0] = 1
            low_res, _ = sam.decode_masks(
                frame["sam"][None], (torch.as_tensor(pts, device=device),
                                     torch.as_tensor(labels, device=device)),
                multimask_output=False)
            masks = postprocess_masks(low_res, (1024, 1024), (H, W), sam.img_size)
            mask = masks[0, 0] > 0.0
            rgb = frame["rgb"]
            red = torch.tensor([1.0, 0.0, 0.0], device=device)
            overlay = torch.where(mask[..., None], 0.5 * rgb + 0.5 * red, rgb)
            img = (torch.clamp(overlay, 0.0, 1.0) * 255.0).to(torch.uint8)
            return (img, mask) if return_mask else img

        return serve
