"""The interactive serve path: render a view, decode a SAM mask from a
click on the rendered embedding, composite the overlay.

Counterpart of ``samnerf_tpu/engine/render_pipeline.py``: ``serve_model``,
the geometry of 3D prompt locking (``backproject``, ``project``,
``visible_mask``, ``pooled_heatmap_points``, ``draw_pins``) and
``SamNerfRenderer`` with ``serve_frame_fn`` (the all-device frame, one
CUDA graph replay on the card),
``render_view`` (the viewer's flow, which locks clicks as 3D points,
decodes ClipSeg text prompts on the rendered ClipSeg grid, and runs
LanguageSAM on the rendered rgb for a model that distills nothing),
``bake_serve_tables`` and ``bake_occupancy`` (a serve occupancy grid that
every later frame and view culls with).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.engine import cuda_graph
from samnerf_tpu_torch.engine.eval_render import ImageRenderer, bake_occupancy
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.ops.hash_grid import bake_quantized_tables
from samnerf_tpu_torch.perception.langsam import composite_mask
from samnerf_tpu_torch.perception.sam.sam import Sam, postprocess_masks

EPS = 1e-4  # visibility epsilon
TOR = 1e-2  # back-projection depth offset


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


def backproject(points_2d: np.ndarray, depth: np.ndarray, intrin: np.ndarray,
                c2w: np.ndarray) -> np.ndarray:
    """2D clicks -> 3D points through the rendered depth, TOR in front of
    the surface.  points_2d [N, 2] (x, y); depth [H, W] or [H, W, 1];
    intrin [3, 3]; c2w [3|4, 4]."""
    depth = depth[..., 0] if depth.ndim == 3 else depth
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    px = points_2d[:, 0].astype(np.int64)
    py = points_2d[:, 1].astype(np.int64)
    t = depth[py, px] - TOR
    x = (points_2d[:, 0] - cx) / fx
    y = -(points_2d[:, 1] - cy) / fy
    coords = np.stack([x, y, -np.ones_like(x)], axis=-1)  # [N, 3]
    direction = coords @ c2w[:3, :3].T
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    return c2w[:3, 3][None] + t[:, None] * direction


def project(intrin: np.ndarray, c2w: np.ndarray,
            points: np.ndarray) -> np.ndarray:
    """3D points [N, 3] -> int32 pixel coords (x, y), truncated."""
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    if c2w.shape[0] == 3:
        c2w = np.concatenate([c2w, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    if points.shape[-1] == 3:
        points = np.concatenate([points, np.ones((points.shape[0], 1))], axis=-1)
    img = points @ np.linalg.inv(c2w)[:3].T  # [N, 3]
    img = -img / img[:, -1:]
    out = np.stack([img[:, 0] * fx + cx, img[:, 1] * (-fy) + cy], axis=-1)
    return out.astype(np.int32)


def visible_mask(prompts_2d: np.ndarray, prompts_3d: np.ndarray,
                 depth: np.ndarray, intrin: np.ndarray, c2w: np.ndarray,
                 t_reduce: str = "min") -> np.ndarray:
    """Pins whose 3D point lies in front of the rendered depth (+EPS) along
    their pixel's ray.  The per-axis distances (p - o) / d skip the axes
    where d is within 1e-8 of 0 and reduce by "min" or by the mean."""
    depth = depth[..., 0] if depth.ndim == 3 else depth
    fx, fy = intrin[0, 0], intrin[1, 1]
    cx, cy = intrin[0, 2], intrin[1, 2]
    coords = (prompts_2d - np.array([[cx, cy]])) / np.array([[fx, -fy]])
    coords = np.concatenate([coords, -np.ones_like(coords[:, :1])], axis=-1)
    rays_d = coords @ c2w[:3, :3].T
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = c2w[:3, 3][None]
    valid = np.abs(rays_d) > 1e-8
    ratios = (prompts_3d - rays_o) / np.where(valid, rays_d, 1.0)
    if t_reduce == "min":
        ts = np.where(valid, ratios, np.inf).min(axis=-1)
    else:
        cnt = np.maximum(valid.sum(axis=-1), 1)
        ts = np.where(valid, ratios, 0.0).sum(axis=-1) / cnt
    d = depth[prompts_2d[:, 1].astype(np.int64), prompts_2d[:, 0].astype(np.int64)]
    return ts < (d + EPS)


def pooled_heatmap_points(heat: np.ndarray, image_hw: Tuple[int, int],
                          topk: int = 1000,
                          threshold: float = 0.7) -> Optional[np.ndarray]:
    """ClipSeg relevance [h, w] -> point prompts [M, 2] (x, y) in image
    pixels: 16x16 average pool, top-k cells above ``threshold``; None when
    no cell passes."""
    fh, fw = heat.shape[0] // 16, heat.shape[1] // 16
    pooled = heat.reshape(fh, 16, fw, 16).mean(axis=(1, 3))
    flat = pooled.reshape(-1)
    amax = np.argsort(-flat)[:min(topk, flat.size)]
    aw, ah = amax % fw, amax // fw
    mask = pooled[ah, aw] > threshold
    if not mask.any():
        return None
    pts = np.stack([aw, ah], axis=1)[mask].astype(np.float32)
    pts[:, 0] = pts[:, 0] / fw * image_hw[1]
    pts[:, 1] = pts[:, 1] / fh * image_hw[0]
    return pts


def draw_pins(image: np.ndarray, pins: np.ndarray, radius: int = 4,
              color=(1.0, 0.0, 0.0)) -> np.ndarray:
    """A copy of ``image`` with a filled disc of ``color`` at each pin
    (x, y), clipped at the borders."""
    img = image.copy()
    h, w = img.shape[:2]
    for x, y in pins.astype(np.int64):
        y0, y1 = max(0, y - radius), min(h, y + radius + 1)
        x0, x1 = max(0, x - radius), min(w, x + radius + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = (yy - y) ** 2 + (xx - x) ** 2 <= radius ** 2
        img[yy[inside], xx[inside]] = color
    return img


def _clone_cameras(cameras: Cameras) -> Cameras:
    """A copy of ``cameras`` in tensors of its own (a graph's static input)."""
    return dataclasses.replace(cameras, **{
        f.name: getattr(cameras, f.name).clone() for f in dataclasses.fields(cameras)
        if isinstance(getattr(cameras, f.name), torch.Tensor)})


def _copy_cameras(dst: Cameras, src: Cameras) -> None:
    for f in dataclasses.fields(src):
        if isinstance(getattr(src, f.name), torch.Tensor):
            getattr(dst, f.name).copy_(getattr(src, f.name))


def cameras_from_intrin_c2w(intrin: np.ndarray, c2w: np.ndarray, height: int,
                            width: int, device="cuda") -> Cameras:
    """One camera from a viewer camera message: intrin [3, 3], c2w [3|4, 4]."""
    def scalar(v):
        return torch.tensor([[float(v)]], device=device)

    return Cameras(
        camera_to_worlds=torch.as_tensor(np.asarray(c2w, np.float32)[None, :3, :4],
                                         device=device),
        fx=scalar(intrin[0, 0]), fy=scalar(intrin[1, 1]),
        cx=scalar(intrin[0, 2]), cy=scalar(intrin[1, 2]),
        width=int(width), height=int(height))


class SamNerfRenderer:
    """The viewer's serve backend over one model.  ``sam_predictor`` (a
    :class:`~samnerf_tpu_torch.perception.sam.predictor.SamPredictor`)
    decodes :meth:`render_view`'s masks on a distilling model's rendered
    SAM embedding, ``clipseg_predictor`` (a
    :class:`~samnerf_tpu_torch.perception.clipseg.pipeline.ClipSegPredictor`)
    its text prompts; ``lang_sam`` (a
    :class:`~samnerf_tpu_torch.perception.langsam.LanguageSAM`) segments
    the rendered rgb of a model that distills nothing.  ``prompts`` [M, 3]
    holds the locked 3D points, ``occ`` the installed occupancy grid (None:
    no culling)."""

    #: "static" trims the SAM-field top-k to 8; "move" also halves the nerf
    #: and proposal counts (the renderer for a moving camera).
    SERVE_PRESETS = {"full": dict(),
                     "static": dict(k=8),
                     "move": dict(nerf=16, props=32, k=2)}

    def __init__(self, model: SAMModel, sam_predictor=None, clipseg_predictor=None,
                 lang_sam=None, chunk: int = 1 << 15, serve_preset: str = "full"):
        model = serve_model(model, **self.SERVE_PRESETS[serve_preset])
        self.renderer = ImageRenderer(model, chunk=chunk)
        self.cfg = model.config
        self.predictor = sam_predictor
        self.clipseg = clipseg_predictor
        self.lang_sam = lang_sam
        self.prompts: Optional[np.ndarray] = None
        self.occ = None
        self._move_renderer: Optional[ImageRenderer] = None
        if serve_preset == "static":
            self._move_renderer = ImageRenderer(
                serve_model(model, **self.SERVE_PRESETS["move"]), chunk=chunk)

    def _renderer_for(self, preset: str) -> ImageRenderer:
        if preset == "move" and self._move_renderer is not None:
            return self._move_renderer
        return self.renderer

    @property
    def device(self) -> torch.device:
        """The device the model renders on."""
        return self.renderer.model.fields.encoding.table.device

    def clear_prompts(self) -> None:
        self.prompts = None

    def bake_occupancy(self, **kw) -> float:
        """Bake and install a serve occupancy grid from the model
        (:func:`samnerf_tpu_torch.engine.eval_render.bake_occupancy`, same
        keywords); frames and views cull empty space from then on.
        Returns the occupied fraction of cells."""
        self.occ, frac = bake_occupancy(self.renderer.model, **kw)
        return frac

    @torch.no_grad()
    def bake_serve_tables(self, optimize: int = 12) -> None:
        """Pre-quantize every hash table at int8 and int4 into the model's
        ``qtable{b}`` / ``qscales{b}`` buffers (with ``optimize``
        candidates of the MSE-optimal scale search; 0 = max scale), and
        their serve-layout copies ``qserve{b}``, so frames skip the
        per-call quantization.  No-op unless the model serves quantized
        tables."""
        if not self.cfg.hash_q8_serve:
            return
        for enc in self.renderer.model.modules():
            if isinstance(enc, ParityHashEncoding):
                baked = bake_quantized_tables({"table": enc.table.detach()},
                                              optimize=optimize)
                for b in (8, 4):
                    enc.set_quantized(b, baked[f"qtable{b}"], baked[f"qscales{b}"])

    def serve_frame_fn(self, sam: Sam, height: int, width: int,
                       max_points: int = 4, preset: str = "primary"):
        """Returns ``serve(cameras, cam_idx, click_xy, return_mask=False)
        -> uint8 [H, W, 3]`` on the model's device: render rgb + SAM and
        ClipSeg grids, decode a mask from the click on the rendered SAM
        embedding, composite the red overlay.  The occupancy grid installed
        when this is called culls every frame of it.

        On the card a frame is one dispatch, as JAX's jitted frame: one
        replay of a CUDA graph of the whole frame, captured on a key's
        first frame (after one eager frame) and kept per key, as
        ``jax.jit`` keeps a trace per shape: the cameras' shapes and size.
        A key's graph is captured anew, in place of the old one, when a
        tensor the model or decoder holds has another address or shape
        than at its capture (baking serve tables, loading weights).  The camera,
        camera index, click and labels are copied into the graph's static
        inputs before each replay; the frame and mask returned are copies,
        which a later replay does not overwrite.  Elsewhere the frame runs
        eagerly.  ``serve.eager`` is the same frame run eagerly on any
        device, the reference the graph is held against."""
        H, W = height, width
        renderer = self._renderer_for(preset)
        occ = self.occ
        cfg = self.cfg
        feats = (("sam", "clipseg") if cfg.distill_sam and cfg.use_clipseg_feature
                 else ("sam",) if cfg.distill_sam else ())
        graphs: Dict[tuple, tuple] = {}     # key -> (held, static inputs, graph)
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def prompt(click_xy):
            # click -> 1024-frame coords (ResizeLongestSide convention)
            scale = 1024.0 / max(H, W)
            pts = np.zeros((1, max_points, 2), np.float32)
            pts[0, 0] = [click_xy[0] * scale, click_xy[1] * scale]
            labels = np.full((1, max_points), -1, np.int64)
            labels[0, 0] = 1
            return torch.from_numpy(pts), torch.from_numpy(labels)

        def frame(cameras: Cameras, cam_idx, pts: torch.Tensor, labels: torch.Tensor):
            device = cameras.camera_to_worlds.device
            rendered = renderer.render_image_device(cameras, cam_idx, W, H, features=feats,
                                                    minimal=True, occ=occ)
            low_res, _ = sam.decode_masks(rendered["sam"][None], (pts, labels),
                                          multimask_output=False)
            masks = postprocess_masks(low_res, (1024, 1024), (H, W), sam.img_size)
            mask = masks[0, 0] > 0.0
            rgb = rendered["rgb"]
            red = (torch.arange(3, device=device) == 0).to(rgb.dtype)     # [1, 0, 0]
            overlay = torch.where(mask[..., None], 0.5 * rgb + 0.5 * red, rgb)
            img = (torch.clamp(overlay, 0.0, 1.0) * 255.0).to(torch.uint8)
            return img, mask

        @torch.no_grad()
        def eager(cameras: Cameras, cam_idx: int, click_xy, return_mask: bool = False):
            device = cameras.camera_to_worlds.device
            pts, labels = prompt(click_xy)
            img, mask = frame(cameras, cam_idx, pts.to(device), labels.to(device))
            return (img, mask) if return_mask else img

        def key_of(cameras: Cameras):
            fields = (getattr(cameras, f.name) for f in dataclasses.fields(cameras))
            return tuple(t.shape if isinstance(t, torch.Tensor) else t for t in fields)

        def held():
            return tuple((t.data_ptr(), t.shape) for m in (renderer.model, sam)
                         for t in (*m.parameters(), *m.buffers()))

        @torch.no_grad()
        def serve(cameras: Cameras, cam_idx: int, click_xy, return_mask: bool = False):
            device = cameras.camera_to_worlds.device
            if device.type != "cuda":
                return eager(cameras, cam_idx, click_xy, return_mask)
            current = torch.cuda.current_stream(device)
            key, tensors = key_of(cameras), held()
            pts, labels = prompt(click_xy)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                if key not in graphs or graphs[key][0] != tensors:
                    graphs.pop(key, None)   # frees the old graph and its pool first
                    static = (_clone_cameras(cameras),
                              torch.tensor(cam_idx, dtype=torch.int64, device=device),
                              pts.to(device), labels.to(device))
                    frame(*static)          # set up cuBLAS and cuDNN on this stream
                    graphs[key] = (tensors, static,
                                   cuda_graph.capture(lambda: frame(*static), side))
                _, (cams, idx, pts_d, labels_d), graph = graphs[key]
                _copy_cameras(cams, cameras)
                idx.fill_(int(cam_idx))
                pts_d.copy_(pts)
                labels_d.copy_(labels)
                img, mask = (t.clone() for t in graph.replay())
            current.wait_stream(side)
            img.record_stream(current)
            mask.record_stream(current)
            return (img, mask) if return_mask else img

        serve.eager = eager
        serve.graphs = graphs
        return serve

    def render_view(self, cameras: Cameras, camera_index: int,
                    intrin: np.ndarray, c2w: np.ndarray,
                    points: Optional[np.ndarray] = None,
                    text_prompt: Optional[str] = None, topk: int = 5, thresh: float = 0.5,
                    width: Optional[int] = None, height: Optional[int] = None,
                    crop_aabb: Optional[np.ndarray] = None,
                    crop_bg: Optional[np.ndarray] = None,
                    preset: str = "static") -> Dict[str, np.ndarray]:
        """The viewer's flow (``samnerf_tpu`` ``render_view``), host numpy
        out: render rgb, depth and the SAM / ClipSeg grids; back-project
        each new click through the depth into a locked 3D point; project
        every locked point into this view and keep those in bounds.

        A distilling model decodes a mask on the rendered SAM embedding
        from those points and, with ``text_prompt`` and a ClipSeg
        predictor, from the ClipSeg heatmap of the prompt decoded on the
        rendered ClipSeg grid (``clipseg_feature`` [512, 512, 1]; its
        points are ``pooled_heatmap_points`` at their defaults, 1000 and
        0.7: ``topk`` and ``thresh`` do not reach them, as in the JAX
        package), composites it and draws the pins that the depth does
        not hide.  A model that distills nothing runs LanguageSAM on the
        rendered rgb with the prompt (default "a man is cooking"), ``topk``
        heatmap points above ``thresh`` and the projected points; it draws
        no pins.

        points: [N, 2] (x, y), all clicks so far; those beyond the locked
        count are new.  None or empty clears the locked points.
        crop_aabb [2, 3] / crop_bg [3]: the viewer's crop box and its
        background.  preset "move" renders through the reduced-sample
        renderer when there is one.  The installed occupancy grid culls.
        Adds ``masked_rgb`` to the render's outputs."""
        cfg = self.cfg
        feats = ("sam", "clipseg") if cfg.distill_sam else ()
        outputs = self._renderer_for(preset).render_image(
            cameras, camera_index, width=width, height=height, features=feats,
            crop_aabb=crop_aabb, crop_bg=crop_bg, occ=self.occ)
        h, w = outputs["rgb"].shape[:2]
        outputs["masked_rgb"] = outputs["rgb"]
        prompt = text_prompt if text_prompt is not None else "a man is cooking"

        if points is None or len(points) == 0:
            self.prompts = None
        else:
            n_locked = 0 if self.prompts is None else len(self.prompts)
            if len(points) > n_locked:
                new_3d = backproject(np.asarray(points[n_locked:], np.float64),
                                     outputs["depth"], intrin, c2w)
                self.prompts = (new_3d if self.prompts is None else
                                np.concatenate([self.prompts, new_3d], axis=0))

        input_points = legal_3d = prompts_2d = None
        if self.prompts is not None:
            prompts_2d = project(intrin, c2w, self.prompts)
            legal = np.logical_and(prompts_2d >= 0,
                                   prompts_2d < np.array([[w, h]])).all(axis=-1)
            prompts_2d = prompts_2d[legal]
            legal_3d = self.prompts[legal]
            input_points = prompts_2d.astype(np.float64)

        if cfg.distill_sam and "sam" in outputs and self.predictor is not None:
            self.predictor.set_feature(outputs["sam"], original_image_size=(h, w))
            if cfg.use_clipseg_feature and self.clipseg is not None \
                    and text_prompt is not None:
                cond = self.clipseg.encode_text([prompt])
                heat = self.clipseg.decode_rendered(outputs["clipseg"], cond).cpu().numpy()
                heat = 1.0 / (1.0 + np.exp(-heat))
                outputs["clipseg_feature"] = heat[..., None]
                clip_points = pooled_heatmap_points(heat, (h, w))
                if clip_points is not None:
                    input_points = (clip_points if input_points is None else
                                    np.concatenate([input_points, clip_points]))
            if input_points is not None and len(input_points) > 0:
                masks, _, _ = self.predictor.predict(
                    point_coords=input_points,
                    point_labels=np.ones(len(input_points), np.int64),
                    multimask_output=False)
                outputs["masked_rgb"] = composite_mask(
                    masks[0], outputs["rgb"], rng=np.random.default_rng(0)).astype(np.float32)
                if prompts_2d is not None and len(prompts_2d) > 0:
                    vis = visible_mask(prompts_2d.astype(np.float64), legal_3d,
                                       outputs["depth"], intrin, c2w)
                    outputs["masked_rgb"] = draw_pins(outputs["masked_rgb"], prompts_2d[vis],
                                                      radius=max(1, int(4 * h / 840)))
        elif not cfg.distill_sam and self.lang_sam is not None:
            rgb_uint8 = (outputs["rgb"] * 255).astype(np.uint8)
            outputs["masked_rgb"] = self.lang_sam.set_and_segment(
                rgb_uint8, prompt, pts=topk, thres=thresh,
                points=input_points).astype(np.float32)
            if self.lang_sam.clipseg_feature is not None:
                outputs["clipseg_feature"] = self.lang_sam.clipseg_feature[..., None]
        return outputs
