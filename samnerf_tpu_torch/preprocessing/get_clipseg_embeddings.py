"""Precompute ClipSeg reduced activations for every training image.

Counterpart of ``samnerf_tpu/preprocessing/get_clipseg_embeddings.py``:
each image of ``<scene>/<images>`` goes through CLIP ViT-B/16 at 512x512
(ImageNet-normalized), its activations at layers (3, 6, 9) are reduced to
64-d by the ClipSeg decoder, and ``<scene>/clipseg_features/<stem>.pt``
holds ``{"activations": 3 x [1025, 1, 64] float32, "visual_q": None}``,
the distillation targets the trainer reads
(``data.feature_loader.clipseg_pt_to_grid``).

Usage (on a machine with an NVIDIA GPU)::

    python -m samnerf_tpu_torch.preprocessing.get_clipseg_embeddings <scene> \\
        --clipseg-checkpoint rd64-uni.pth --clip-checkpoint ViT-B-16.pt [--images images]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def get_embeddings(scene: Path, clipseg_checkpoint: str, clip_checkpoint: str,
                   images_dir: str = "images", device="cuda") -> None:
    import torch
    from PIL import Image

    from samnerf_tpu_torch.perception.clipseg.pipeline import ClipSegPredictor

    predictor = ClipSegPredictor(clipseg_checkpoint=clipseg_checkpoint,
                                 clip_checkpoint=clip_checkpoint, device=device)
    out_dir = Path(scene) / "clipseg_features"
    out_dir.mkdir(exist_ok=True)
    for p in sorted((Path(scene) / images_dir).iterdir()):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        acts = predictor.reduced_activations(np.asarray(Image.open(p).convert("RGB")))
        torch.save({"activations": [torch.from_numpy(a) for a in acts], "visual_q": None},
                   out_dir / f"{p.stem}.pt")
        print(f"saved {p.stem}.pt")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("scene", type=str)
    p.add_argument("--clipseg-checkpoint", type=str, required=True)
    p.add_argument("--clip-checkpoint", type=str, required=True)
    p.add_argument("--images", type=str, default="images")
    a = p.parse_args(argv)
    get_embeddings(Path(a.scene), a.clipseg_checkpoint, a.clip_checkpoint, a.images)


if __name__ == "__main__":
    main()
