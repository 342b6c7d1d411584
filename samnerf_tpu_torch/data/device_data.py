"""The whole training set on the card, and batches sampled there.

Counterpart of ``samnerf_tpu/data/device_data.py``: uint8 images and
float32 feature maps live in device memory once; each batch is drawn on
the device from a ``torch.Generator`` (uniform pixels, or patch-major
patches with the SAM target at each patch's centre pixel, the DINO and
ClipSeg targets at every pixel), so a step
moves nothing from the host.  The index arithmetic after the uniform
draw (:func:`indices_from_uniform`) and the gathers (:func:`gather_batch`)
are the JAX package's; only the random numbers differ.  This is the
port's one batch path: the trainer calls :func:`sample_batch`.
"""
from __future__ import annotations

from typing import Dict

import torch


def build_device_dataset(datamanager, device) -> Dict[str, torch.Tensor]:
    """Images [N, H, W, 3] uint8, feature maps [N, fh, fw, C] f32, and the
    depth datamanager's ``depths`` [N, H, W] f32 or the semantic one's
    ``semantics`` [N, H, W] int32."""
    data = {"images": torch.as_tensor(datamanager.images, device=device)}
    if datamanager.sam_features is not None:
        data["sam_features"] = torch.as_tensor(datamanager.sam_features, device=device)
    if datamanager.dino_features is not None:
        data["dino_features"] = torch.as_tensor(datamanager.dino_features, device=device)
    if datamanager.clipseg_features is not None:
        data["clipseg_features"] = torch.as_tensor(datamanager.clipseg_features,
                                                   device=device)
    for name in ("depths", "semantics"):          # the zoo's extra channels
        if getattr(datamanager, name, None) is not None:
            data[name] = torch.as_tensor(getattr(datamanager, name), device=device)
    return data


def uniform_shape(batch_size: int, patch_size: int = 1):
    """Shape of the uniform draw behind one batch: one (img, row, col)
    triple per pixel, or per patch when patch_size > 1."""
    return (batch_size if patch_size <= 1 else batch_size // (patch_size ** 2), 3)


def _scaled(u: torch.Tensor, dims) -> torch.Tensor:
    """Each column of u [B, 3] times its entry of ``dims``: the products of
    ``u * tensor(dims)``, without the copy of ``dims`` to the device that a
    CUDA graph cannot capture."""
    return torch.stack([u[:, i] * float(d) for i, d in enumerate(dims)], dim=-1)


def indices_from_uniform(u: torch.Tensor, num_images: int, height: int, width: int,
                         patch_size: int = 1) -> torch.Tensor:
    """Uniform draws u [uniform_shape(...)] in [0, 1) -> [B, 3] int64
    (img, row, col); patch-major when patch_size > 1.  Computed in u's
    dtype."""
    ps = patch_size
    if ps <= 1:
        return torch.floor(_scaled(u, (num_images, height, width))).long()
    # floored after the offset, as the reference
    base = _scaled(u, (num_images, height - ps, width - ps))[:, None, None, :]
    yy, xx = torch.meshgrid(torch.arange(ps, device=u.device),
                            torch.arange(ps, device=u.device), indexing="ij")
    offs = torch.stack([torch.zeros_like(yy), yy, xx], -1).to(u.dtype)
    return torch.floor(base + offs).long().reshape(-1, 3)


def sample_indices(generator: torch.Generator, batch_size: int, num_images: int,
                   height: int, width: int, patch_size: int = 1,
                   device="cuda") -> torch.Tensor:
    """[B, 3] int64 (img, row, col) drawn from ``generator``."""
    u = torch.rand(uniform_shape(batch_size, patch_size), generator=generator,
                   device=device)
    return indices_from_uniform(u, num_images, height, width, patch_size)


def patch_centers(indices: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The centre pixel of each patch of patch-major indices [B, 3]."""
    ps = patch_size
    return indices.reshape(-1, ps, ps, 3)[:, ps // 2, ps // 2, :] if ps > 1 else indices


def lookup_features(features: torch.Tensor, indices: torch.Tensor,
                    image_hw) -> torch.Tensor:
    """Nearest feature at scaled pixel coords: features [N, fh, fw, C],
    indices [B, 3] -> [B, C]."""
    fh, fw = features.shape[1], features.shape[2]
    r = (indices[:, 1].float() * (fh / image_hw[0])).long()
    c = (indices[:, 2].float() * (fw / image_hw[1])).long()
    return features[indices[:, 0], r, c].float()


def gather_batch(data: Dict[str, torch.Tensor], indices: torch.Tensor, patch_size: int,
                 image_hw) -> Dict[str, torch.Tensor]:
    """The batch at ``indices``: rgb in [0, 1], the SAM target at each
    patch centre, the DINO and ClipSeg targets at each pixel, and the
    depth (``depth_image``) or class id (``semantics``) at each pixel, [B,
    1]."""
    batch = {"indices": indices,
             "image": data["images"][indices[:, 0], indices[:, 1], indices[:, 2]]
             .float() / 255.0}
    if "sam_features" in data:
        batch["sam"] = lookup_features(data["sam_features"],
                                       patch_centers(indices, patch_size), image_hw)
    if "dino_features" in data:
        batch["dino"] = lookup_features(data["dino_features"], indices, image_hw)
    if "clipseg_features" in data:
        batch["clipseg"] = lookup_features(data["clipseg_features"], indices, image_hw)
    if "depths" in data:
        batch["depth_image"] = data["depths"][indices[:, 0], indices[:, 1],
                                              indices[:, 2]][:, None]
    if "semantics" in data:
        batch["semantics"] = data["semantics"][indices[:, 0], indices[:, 1],
                                               indices[:, 2]][:, None]
    return batch


def sample_batch(generator: torch.Generator, data: Dict[str, torch.Tensor],
                 batch_size: int, patch_size: int, image_hw) -> Dict[str, torch.Tensor]:
    """One training batch, drawn and gathered on the data's device."""
    n, h, w = data["images"].shape[:3]
    indices = sample_indices(generator, batch_size, n, h, w, patch_size,
                             device=data["images"].device)
    return gather_batch(data, indices, patch_size, image_hw)
