"""Image quality metrics: PSNR, SSIM and LPIPS (VGG16).

Counterpart of ``samnerf_tpu/utils/metrics.py``, same functions and
constants.  Images are [H, W, 3] tensors in [0, 1] on any device; each
metric runs where its inputs are.  SSIM's Gaussian filter and LPIPS's
VGG16 are convolutions (``F.conv2d``, ``F.max_pool2d``), as the JAX
package computes them with ``conv_general_dilated`` and ``reduce_window``
outside any Pallas kernel.

LPIPS needs pretrained weights, which are supplied at run time:
torchvision's ``vgg16-397923af.pth`` (its ``features.*`` convolutions)
and the lpips package's ``vgg.pth`` linear heads.  :class:`LPIPS` loads
both state dicts as they are (:func:`convert_lpips_weights` only renames
the heads); :func:`load_lpips_params` returns None when the files are
absent, and then no ``lpips`` metric is written.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    """[size, size] f32, the outer product of a normalised 1D Gaussian."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Gaussian-window SSIM over [H, W, C] images in [0, 1], the mean of
    the per-pixel scores over the VALID region (torchmetrics' defaults)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    pred = pred.float()
    target = target.float()
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)[None, None]

    def filt(x):
        # [H, W, C] -> depthwise VALID convolution -> [h, w, C]
        return F.conv2d(x.permute(2, 0, 1)[:, None], kern)[:, 0].permute(1, 2, 0)

    mu_p = filt(pred)
    mu_t = filt(target)
    # E[x^2]-E[x]^2 can go slightly negative in floating point; clamp the
    # variances at 0 and bound the covariance by Cauchy-Schwarz so the
    # per-pixel score stays in [-1, 1] whatever the input scale.
    var_p = torch.clamp_min(filt(pred * pred) - mu_p ** 2, 0.0)
    var_t = torch.clamp_min(filt(target * target) - mu_t ** 2, 0.0)
    cov = filt(pred * target) - mu_p * mu_t
    bound = torch.sqrt(var_p * var_t)
    cov = torch.minimum(torch.maximum(cov, -bound), bound)
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


# --- LPIPS (VGG16 variant) ----------------------------------------------------
#
# VGG16 features tapped at relu{1_2,2_2,3_3,4_3,5_3}, unit-normalised over
# channels, squared differences through learned non-negative 1x1 "lin"
# heads, averaged over space and summed over the taps.

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
_TAPS = (1, 3, 6, 9, 12)            # conv indices of relu1_2..relu5_3
_SHIFT = (-0.030, -0.088, -0.188)   # lpips normalisation constants
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS with VGG16 features.  ``features`` has torchvision's
    ``vgg16().features`` layout up to relu5_3 (so its ``features.*`` keys
    load as they are); ``lins.i.weight`` [1, C, 1, 1] are the heads."""

    def __init__(self, device="cuda"):
        super().__init__()
        layers, ch = [], 3
        for c in _VGG_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(ch, c, 3, padding=1, device=device), nn.ReLU()]
            ch = c
        self.features = nn.Sequential(*layers)
        widths = [c for i, c in enumerate(c for c in _VGG_CFG if c != "M") if i in _TAPS]
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False, device=device)
                                  for c in widths)

    def _taps(self, x: torch.Tensor):
        feats, ci = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if ci in _TAPS:
                    feats.append(x)
                ci += 1
        return feats

    @torch.no_grad()
    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred, target [H, W, 3] in [0, 1] -> scalar distance."""
        x = torch.stack([pred, target]).float().permute(0, 3, 1, 2)
        shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
        x = (x * 2.0 - 1.0 - shift) / scale
        total = torch.zeros((), device=x.device)
        for feat, lin in zip(self._taps(x), self.lins):
            feat = feat / torch.clamp_min(feat.norm(dim=1, keepdim=True), 1e-10)
            d = (feat[0] - feat[1]) ** 2                         # [C, h, w]
            total = total + torch.mean(torch.einsum("chw,c->hw", d, lin.weight[0, :, 0, 0]))
        return total


def convert_lpips_weights(vgg_state_dict: Mapping[str, torch.Tensor],
                          lin_state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision VGG16 + lpips heads -> :class:`LPIPS`'s state dict: the
    convolutions' ``features.*`` keys as they are, the heads'
    ``lin{i}.model.1.weight`` (or ``lins.{i}.model.1.weight``) as
    ``lins.{i}.weight``."""
    keys = LPIPS(device="meta").state_dict()
    state = {k: torch.as_tensor(vgg_state_dict[k]) for k in keys if k.startswith("features.")}
    for i in range(len(_TAPS)):
        k = (f"lin{i}.model.1.weight" if f"lin{i}.model.1.weight" in lin_state_dict
             else f"lins.{i}.model.1.weight")
        state[f"lins.{i}.weight"] = torch.as_tensor(lin_state_dict[k])
    return state


def lpips(pred: torch.Tensor, target: torch.Tensor, model: LPIPS) -> torch.Tensor:
    """pred/target [H, W, 3] in [0, 1]; ``model`` from :func:`load_lpips_params`."""
    return model(pred, target)


def load_lpips_params(vgg_path: Optional[str] = None, lin_path: Optional[str] = None,
                      device="cuda") -> Optional[LPIPS]:
    """The LPIPS model on ``device`` if both weight files exist, else None.

    Default locations: $LPIPS_VGG_WEIGHTS / $LPIPS_LIN_WEIGHTS, or
    ./checkpoints/vgg16-397923af.pth + ./checkpoints/lpips_vgg.pth."""
    vgg_path = vgg_path or os.environ.get("LPIPS_VGG_WEIGHTS",
                                          "checkpoints/vgg16-397923af.pth")
    lin_path = lin_path or os.environ.get("LPIPS_LIN_WEIGHTS", "checkpoints/lpips_vgg.pth")
    if not (Path(vgg_path).exists() and Path(lin_path).exists()):
        return None
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    model = LPIPS(device="meta")
    model.load_state_dict(convert_lpips_weights(vgg_sd, lin_sd), assign=True)
    return model.to(device).eval()
