"""ClipSeg inference: image and text -> dense relevance logits, and the
decode of a rendered feature grid.  Counterpart of
``samnerf_tpu/perception/clipseg/pipeline.py``.

- Image path: the image resized to 512x512 (PIL bilinear, on the host)
  and ImageNet-normalized, CLIP ViT-B/16's activations at the extract
  layers, the decoder, logits [512, 512] (pre-sigmoid).
- Feature path: a rendered 32x32x192 grid split into 3 x 64-d slices,
  each with a class token that is the mean of its tokens, through the
  decoder's ``decode``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from samnerf_tpu_torch.perception.clipseg import tokenizer as tok
from samnerf_tpu_torch.perception.clipseg.clip_model import (CLIPText, CLIPVisual,
                                                             load_clip_state_dict, load_subset)
from samnerf_tpu_torch.perception.clipseg.clipseg import CLIPDensePredT
from samnerf_tpu_torch.utils.init import init_state

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(image: np.ndarray, size: int = 512) -> np.ndarray:
    """HWC uint8 (or float in [0, 1]) -> [1, size, size, 3]
    ImageNet-normalized, resized with PIL's bilinear filter."""
    from PIL import Image
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(image).resize((size, size), Image.BILINEAR)
    x = np.asarray(pil, np.float32) / 255.0
    x = (x - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    return x[None]


class ClipSegPredictor:
    """CLIP's two towers and the ClipSeg decoder on ``device``.

    ``clip_checkpoint`` is an OpenAI CLIP ViT-B/16 state dict (or a module
    with ``state_dict()``, such as the published TorchScript file);
    ``clipseg_checkpoint`` is ``rd64-uni.pth``.  Keys the modules do not
    use (``logit_scale``, the CLIP keys inside ``rd64-uni.pth``) are
    ignored, as the reference's ``strict=False`` load does; a missing key
    raises.  Without a checkpoint, weights are drawn from ``seed``
    (``utils.init.init_state`` on the CPU, then moved).  ``bpe_path`` is
    the tokenizer's merges file, needed by :meth:`encode_text`."""

    def __init__(self, clipseg_checkpoint: Optional[str] = None,
                 clip_checkpoint: Optional[str] = None, bpe_path: Optional[str] = None,
                 extract_layers=(3, 6, 9), reduce_dim: int = 64, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        self.extract_layers = tuple(extract_layers)
        self.visual = CLIPVisual(device="meta")
        self.text = CLIPText(device="meta")
        self.decoder = CLIPDensePredT(self.extract_layers, reduce_dim=reduce_dim,
                                      device="meta")
        gen = torch.Generator().manual_seed(seed)
        if clip_checkpoint is not None:
            # the published ViT-B-16.pt is a TorchScript archive, which only
            # a full (not weights-only) load opens
            sd = torch.load(clip_checkpoint, map_location="cpu", weights_only=False)
            load_clip_state_dict(self.visual, self.text,
                                 sd.state_dict() if hasattr(sd, "state_dict") else sd,
                                 self.device)
        else:
            for m in (self.visual, self.text):
                m.load_state_dict(init_state(m, gen, self.device), assign=True)
        if clipseg_checkpoint is not None:
            load_subset(self.decoder, torch.load(clipseg_checkpoint, map_location="cpu",
                                                 weights_only=True), "", self.device)
        else:
            self.decoder.load_state_dict(init_state(self.decoder, gen, self.device),
                                         assign=True)
        for m in (self.visual, self.text, self.decoder):
            m.eval()
        self.tokenizer = tok.SimpleTokenizer(bpe_path) if bpe_path is not None else None

    @torch.no_grad()
    def encode_text(self, texts: Union[str, Sequence[str]]) -> torch.Tensor:
        """-> the text embeddings [B, 512] (the decoder's condition)."""
        if self.tokenizer is None:
            raise RuntimeError("no BPE merges loaded; pass "
                               "bpe_path=.../bpe_simple_vocab_16e6.txt.gz")
        tokens = tok.tokenize(self.tokenizer, texts)
        return self.text(torch.as_tensor(tokens, device=self.device))

    def _activations(self, image: np.ndarray) -> List[torch.Tensor]:
        x = torch.as_tensor(normalize_image(image), dtype=torch.float32, device=self.device)
        return self.visual(x, self.extract_layers)[1]

    @torch.no_grad()
    def segment(self, image: np.ndarray, cond: torch.Tensor) -> torch.Tensor:
        """image HWC -> logits [512, 512] (pre-sigmoid)."""
        return self.decoder(self._activations(image), cond)[0, ..., 0]

    @torch.no_grad()
    def reduced_activations(self, image: np.ndarray) -> List[np.ndarray]:
        """An image's distillation targets: 3 x [N + 1, 1, 64] f32 (the
        reference's token-major layout)."""
        reduced = self.decoder.reduce_activations(self._activations(image))
        return [r.cpu().numpy().transpose(1, 0, 2) for r in reduced]

    @torch.no_grad()
    def decode_rendered(self, clipseg_grid, cond: torch.Tensor) -> torch.Tensor:
        """A rendered grid [32, 32, 192] -> logits [512, 512]: 3 x 64-d
        slices, each with the mean of its tokens as the class token."""
        g = torch.as_tensor(clipseg_grid, dtype=torch.float32, device=self.device)
        g = g.reshape(-1, 3, 64).transpose(0, 1)
        racts = [torch.cat([a.mean(dim=1, keepdim=True), a], dim=1)
                 for a in (g[i][None] for i in range(3))]
        return self.decoder.decode(racts, cond)[0, ..., 0]

