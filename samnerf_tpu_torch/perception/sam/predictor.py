"""Stateful SamPredictor: set_image / set_feature / predict, counterpart of
``samnerf_tpu/perception/sam/predictor.py``.

``set_feature`` is the distillation hook: it takes an embedding rendered
by the NeRF (zero-padding a rectangular map to the square grid) in place
of running the ViT.

As the JAX predictor jits the encode once and the decode once per prompt
signature, the port runs each as one CUDA graph replay on the card
(:class:`samnerf_tpu_torch.engine.cuda_graph.KeyedGraphs`): one encode
graph, and one decode graph per (point bucket, has box, has mask,
multimask) for ``predict`` and per (``"batched"``, prompt shape,
multimask) for ``predict_batched``.  Point prompts are padded to the
JAX package's buckets (:data:`_PROMPT_BUCKETS`) with label -1 and the
padding is masked out of the decoder (``Sam.decode_masks(num_valid_points
=...)``), so every click count within a bucket replays one graph.  The
graphs read static buffers that the host refills before each replay: the
preprocessed image, always padded to the encoder's square, so one encode
graph serves every image size; the features, which the encode graph and
``set_feature`` write and every decode graph reads; and each decode
graph's prompt.  The image normalisation and the mask postprocess stay
outside the graphs, as they stay outside JAX's jit.  Elsewhere (the CPU,
or ``use_graphs=False``) the same functions run eagerly through the same
buffers and buckets.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.engine import cuda_graph
from samnerf_tpu_torch.perception.sam.sam import PROMPT_EMBED_DIM, Sam, postprocess_masks
from samnerf_tpu_torch.perception.sam.transforms import ResizeLongestSide

_PROMPT_BUCKETS = (1, 4, 16, 64, 256, 1024, 2048)


def _bucket(n: int) -> int:
    """The static point count a prompt of ``n`` points is padded to."""
    for b in _PROMPT_BUCKETS:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(n)))


class SamPredictor:
    """``use_graphs``: on the card, encode and decode by graph replay
    (the default) or eagerly; the CPU always runs eagerly."""

    def __init__(self, sam_model: Sam, use_graphs: bool = True) -> None:
        self.model = sam_model
        self.transform = ResizeLongestSide(sam_model.img_size)
        self.device = sam_model.mask_decoder.iou_token.weight.device
        self.use_graphs = use_graphs
        eh, ew = sam_model.prompt_encoder.image_embedding_size
        self._features = torch.zeros((1, eh, ew, PROMPT_EMBED_DIM), device=self.device)
        self._image: Optional[torch.Tensor] = None      # [1, S, S, 3], made on first use
        self._prompts = {}          # decode key -> its static prompt tensors
        # one pool for the encode and every decode graph: a long-lived
        # predictor meets many prompt signatures, and each call copies its
        # outputs before the next
        self._graphs = (cuda_graph.KeyedGraphs(self.device, share_pool=True)
                        if self.device.type == "cuda" else None)
        # calls of each kind, for the caller's bookkeeping
        self.calls = {"eager": 0, "captured": 0, "replayed": 0}
        self.reset_image()

    def reset_image(self) -> None:
        self.is_image_set = False
        self.original_size = None
        self.input_size = None

    def _held(self) -> tuple:
        """What a graph reads in place: the model's tensors and the buffers."""
        return tuple((t.data_ptr(), t.shape) for t in (
            *self.model.parameters(), *self.model.buffers(), self._features,
            *(() if self._image is None else (self._image,))))

    def _run(self, key, fn):
        """``fn()`` by graph replay on the card (inside ``on_stream``), else
        eagerly."""
        if self._graphs is None or not self.use_graphs:
            self.calls["eager"] += 1
            return fn()
        out, how = self._graphs.run(key, fn, self._held)
        self.calls[how] += 1
        return out

    def _on_stream(self):
        if self._graphs is None or not self.use_graphs:
            return contextlib.nullcontext()
        return self._graphs.on_stream()

    @torch.no_grad()
    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """image: HWC uint8.  Runs the image encoder into the features
        buffer."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format must be RGB or BGR, got {image_format!r}")
        if image_format == "BGR":
            image = image[..., ::-1]
        input_image = self.transform.apply_image(np.ascontiguousarray(image))
        self.original_size = tuple(image.shape[:2])
        self.input_size = tuple(input_image.shape[:2])
        x = torch.from_numpy(np.array(input_image)).to(self.device, torch.float32)[None]
        x = self.model.preprocess(x)                    # [1, S, S, 3]
        if self._image is None or self._image.shape != x.shape:
            self._image = torch.empty_like(x)
        with self._on_stream():
            self._image.copy_(x)
            self._run(("encode", self.model.image_encoder.compute_dtype),
                      lambda: self._features.copy_(self.model.encode_image(self._image)))
        self.is_image_set = True

    def set_feature(self, feature, original_image_size: Tuple[int, int]) -> None:
        """A rendered embedding [h, w, 256] (h or w == the grid size), NHWC
        (the reference takes CHW), zero-padded into the features buffer."""
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
        if self._features.shape[1:3] != (side, side):
            raise ValueError(f"a {fh}x{fw} feature pads to {side}x{side}, not the "
                             f"model's {tuple(self._features.shape[1:3])} grid")
        self._features.zero_()
        self._features[0, :fh, :fw].copy_(feature)
        self.is_image_set = True

    def _prompt(self, key, **tensors):
        """The key's static prompt tensors, refilled from ``tensors``."""
        static = self._prompts.get(key)
        if static is None:
            static = self._prompts[key] = {k: v.clone() for k, v in tensors.items()}
        else:
            for k, v in tensors.items():
                static[k].copy_(v)
        return static

    def _finish(self, low_res, iou, return_logits):
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
        tensors, n = {}, None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels must be given with point_coords")
            pc = self.transform.apply_coords(point_coords, self.original_size)
            n = pc.shape[0]
            b = _bucket(n)
            coords = np.zeros((1, b, 2), np.float32)
            labels = -np.ones((1, b), np.int64)
            coords[0, :n] = pc
            labels[0, :n] = np.asarray(point_labels)
            tensors.update(coords=torch.from_numpy(coords), labels=torch.from_numpy(labels),
                           num_valid=torch.tensor([n]))
        if box is not None:
            tensors["boxes"] = torch.as_tensor(
                self.transform.apply_boxes(box, self.original_size), dtype=torch.float32)
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            tensors["mask_in"] = torch.from_numpy(m.reshape(1, *m.shape[-2:], 1))
        key = (None if n is None else tensors["coords"].shape[1], box is not None,
               mask_input is not None, multimask_output)
        with self._on_stream():
            p = self._prompt(key, **{k: v.to(self.device) for k, v in tensors.items()})

            def decode():
                points = (p["coords"], p["labels"]) if "coords" in p else None
                return self.model.decode_masks(self._features, points, p.get("boxes"),
                                               p.get("mask_in"), multimask_output,
                                               num_valid_points=p.get("num_valid"))

            low_res, iou = self._run(key, decode)
            masks, iou, low_res = self._finish(low_res, iou, return_logits)
        return masks[0], iou[0], low_res[0]

    @torch.no_grad()
    def predict_batched(self, point_coords: np.ndarray, point_labels: np.ndarray,
                        multimask_output: bool = True, return_logits: bool = False):
        """B independent prompt sets at once: coords [B, N, 2] already in
        the input frame, labels [B, N] -> (masks [B, C, H, W], iou [B, C],
        low-res [B, C, 4e, 4e]) as numpy.  Every point is real: no
        padding, no mask."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set before mask prediction.")
        key = ("batched", tuple(np.shape(point_coords)), multimask_output)
        with self._on_stream():
            p = self._prompt(key, coords=torch.as_tensor(
                np.asarray(point_coords, np.float32), device=self.device),
                labels=torch.as_tensor(np.asarray(point_labels, np.int64),
                                       device=self.device))
            low_res, iou = self._run(key, lambda: self.model.decode_masks(
                self._features, (p["coords"], p["labels"]), None, None, multimask_output))
            return self._finish(low_res, iou, return_logits)

    def get_image_embedding(self) -> torch.Tensor:
        """[1, 64, 64, 256] NHWC: a copy, which a later ``set_image`` or
        ``set_feature`` does not overwrite."""
        if not self.is_image_set:
            raise RuntimeError("image not set")
        return self._features.clone()

