"""The SAM decoder as a portable artifact.

Counterpart of ``samnerf_tpu/perception/sam/export.py`` (the reference's
``SamOnnxModel``: prompt encoder and mask decoder with the image embedding
as an input, served without the ViT).  JAX's StableHLO becomes
``torch.export``: :func:`export_decoder` gives the bytes of
``torch.export.save``, which :func:`load_and_run` loads and calls.  The
input contract is the JAX one: image embeddings NHWC [1, 64, 64, 256]
f32, point coords [1, N, 2] f32 in the 1024 frame, point labels [1, N]
int32 with -1 as padding; outputs (low-res masks [1, k, 256, 256], iou
[1, k]).  The artifact holds the weights and runs on the device it was
exported on.
"""
from __future__ import annotations

import dataclasses
import io
from pathlib import Path
from typing import Tuple

import torch
from torch import nn

from samnerf_tpu_torch.perception.sam.sam import Sam


@dataclasses.dataclass
class SamDecoderExport:
    """A serialized decoder and its calling convention."""
    artifact: bytes
    num_points: int
    multimask_output: bool


class _Decoder(nn.Module):
    """(embeddings, coords, labels) -> ``Sam.decode_masks``."""

    def __init__(self, sam: Sam, multimask_output: bool):
        super().__init__()
        self.sam = sam
        self.multimask_output = multimask_output

    def forward(self, embeddings, coords, labels):
        return self.sam.decode_masks(embeddings, (coords, labels),
                                     multimask_output=self.multimask_output)


def export_decoder(sam: Sam, num_points: int = 5, multimask_output: bool = False,
                   embed_hw: Tuple[int, int] = (64, 64)) -> SamDecoderExport:
    """``torch.export`` of ``sam``'s prompt encoder and mask decoder for
    ``num_points`` prompt points, on ``sam``'s device."""
    dev = sam.mask_decoder.iou_token.weight.device
    args = (torch.zeros((1, *embed_hw, 256), device=dev),
            torch.zeros((1, num_points, 2), device=dev),
            torch.full((1, num_points), -1, dtype=torch.int32, device=dev))
    with torch.no_grad():
        program = torch.export.export(_Decoder(sam, multimask_output).eval(), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return SamDecoderExport(artifact=buf.getvalue(), num_points=num_points,
                            multimask_output=multimask_output)


def save_decoder(path: Path, exp: SamDecoderExport) -> None:
    Path(path).write_bytes(exp.artifact)


def load_decoder(path_or_bytes):
    """The exported program's callable module, from a file or bytes."""
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else Path(path_or_bytes).read_bytes())
    return torch.export.load(io.BytesIO(bytes(data))).module()


def load_and_run(path_or_bytes, embeddings, coords, labels):
    """Load the exported decoder and call it: (low-res masks, iou)."""
    with torch.no_grad():
        return load_decoder(path_or_bytes)(embeddings, coords, labels)
