"""Precompute SAM image-encoder embeddings for every training image.

Counterpart of ``samnerf_tpu/preprocessing/get_image_embeddings.py``: run
the SAM ViT encoder on each image of ``<scene>/<images>``, crop the padded
square 64x64 embedding back to the image's aspect and save
``<scene>/sam_features/<stem>.npy`` as ``[256, h, w]`` float32, the
distillation targets the trainer reads.

Usage (on a machine with an NVIDIA GPU)::

    python -m samnerf_tpu_torch.preprocessing.get_image_embeddings <scene> \\
        --checkpoint sam_vit_h_4b8939.pth [--model-type vit_h] [--images images]

The checkpoint is a state dict in the reference torch SAM's layout.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np


def get_embeddings(scene: Path, checkpoint: str, model_type: str = "vit_h",
                   images_dir: str = "images", device="cuda") -> None:
    from PIL import Image

    from samnerf_tpu_torch.perception.sam.build_sam import sam_model_registry
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    predictor = SamPredictor(sam_model_registry[model_type](checkpoint=checkpoint,
                                                            device=device))
    out_dir = Path(scene) / "sam_features"
    out_dir.mkdir(exist_ok=True)
    for p in sorted((Path(scene) / images_dir).iterdir()):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        img = np.asarray(Image.open(p).convert("RGB"))
        predictor.set_image(img)
        emb = predictor.get_image_embedding()[0].cpu().numpy()   # [64, 64, 256]
        h, w = img.shape[:2]
        if h < w:
            emb = emb[:int(math.ceil(h / w * emb.shape[0]))]
        elif h > w:
            emb = emb[:, :int(math.ceil(w / h * emb.shape[1]))]
        np.save(out_dir / f"{p.stem}.npy", emb.transpose(2, 0, 1).astype(np.float32))
        print(f"saved {p.stem}.npy {emb.shape}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("scene", type=str)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--model-type", type=str, default="vit_h")
    p.add_argument("--images", type=str, default="images")
    a = p.parse_args(argv)
    get_embeddings(Path(a.scene), a.checkpoint, a.model_type, a.images)


if __name__ == "__main__":
    main()
