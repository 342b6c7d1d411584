"""DINO ViT descriptors, the distillation targets of the DINO head.

Counterpart of ``samnerf_tpu/preprocessing/get_dino_embeddings.py``: a
pre-norm ViT (LayerNorm eps 1e-6, exact GELU) whose patch convolution runs
at a reduced ``stride`` for denser patches, its position grid resized to
the strided grid with ``jax.image.resize``'s bicubic weights
(:func:`samnerf_tpu_torch.perception.clipseg.clip_model.bicubic_resize_matrix`),
and per-layer facets (``query``, ``key``, ``value`` and ``attn`` per head,
and the block's output ``token``), optionally log-binned (:func:`log_bin`).

Module and parameter names are the reference torch checkpoint's
(``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``),
so ``dino_vits8.pth`` loads through :func:`load_dino_state_dict` as it is.
Attention is a plain matmul and softmax (XLA in the JAX package, no TPU
kernel).  When no layer asks for the ``attn`` facet, the queries are taken
``query_chunk`` rows at a time, which bounds the [heads, rows, tokens]
logits (6 x 16,130^2 f32 is 6.2 GB at a 512^2 image and stride 4); rows are
independent, so the function is the same.  With ``compute_dtype``
bfloat16 the patch convolution and the dense layers run in bf16 with JAX's
rounding points (:mod:`samnerf_tpu_torch.utils.dtypes`), the softmax in f32,
and the residual stream stays f32, as in the JAX module.

Usage (on a machine with an NVIDIA GPU)::

    python -m samnerf_tpu_torch.preprocessing.get_dino_embeddings <scene>/images \\
        --output-path <scene>/dino_features [--checkpoint dino_vits8.pth] \\
        [--model-type dino_vits8] [--stride 4] [--layer 11] [--facet key] [--bin]

It writes ``<stem>.pt`` per image, a [gh, gw, heads * head_dim] float32
tensor (``--bin``: 17 times as wide).  Given a directory that holds no
image but an ``images/`` directory (a scene), it reads ``images/``.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from samnerf_tpu_torch.perception.clipseg.clip_model import bicubic_resize_matrix
from samnerf_tpu_torch.utils.dtypes import gelu, layer_norm, linear, resolve_dtype, scalar

DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)

_SPECS = {
    "dino_vits8": dict(patch=8, width=384, layers=12, heads=6),
    "dino_vits16": dict(patch=16, width=384, layers=12, heads=6),
    "dino_vitb8": dict(patch=8, width=768, layers=12, heads=12),
    "dino_vitb16": dict(patch=16, width=768, layers=12, heads=12),
}

FACETS = ("query", "key", "value", "attn", "token")
QUERY_CHUNK = 4096
"""Rows of queries per attention product when no ``attn`` facet is asked
for: 1.59 GB of f32 logits a chunk at ViT-S/8's 6 heads and a 512^2
image's 16,130 tokens.  On an H100 this runs as fast as the whole product
in about a quarter of its memory; 2048 rows run 10 % slower (``PERF.md``,
``chip_smoke.py``'s dino phase)."""
IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")


class _Attention(nn.Module):
    def __init__(self, width: int, device="cuda"):
        super().__init__()
        self.qkv = nn.Linear(width, 3 * width, device=device)
        self.proj = nn.Linear(width, width, device=device)


class _Mlp(nn.Module):
    def __init__(self, width: int, device="cuda"):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width, device=device)
        self.fc2 = nn.Linear(4 * width, width, device=device)


class DinoBlock(nn.Module):
    """x += proj(softmax(q kᵀ / sqrt(d)) v) over norm1(x); x += fc2(gelu(fc1(
    norm2(x)))).  The softmax is taken in f32 and kept in the residual's
    dtype (f32), so its product with v runs in f32, as JAX promotes it."""

    def __init__(self, width: int, heads: int, compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.heads = heads
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.norm1 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.attn = _Attention(width, device)
        self.norm2 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.mlp = _Mlp(width, device)

    def forward(self, x: torch.Tensor, facets: Sequence[str] = (),
                query_chunk: Optional[int] = None):
        """x [B, N, D] f32 -> (x, {facet: tensor} for ``facets``): query,
        key, value [B, heads, N, head_dim] in ``compute_dtype``, attn [B,
        heads, N, N] and token [B, N, D] f32.  ``query_chunk`` rows of
        queries at a time unless ``attn`` is asked for."""
        dt = self.compute_dtype
        B, N, D = x.shape
        head = D // self.heads
        qkv = linear(layer_norm(x, self.norm1, dt), self.attn.qkv, dt)
        q, k, v = qkv.reshape(B, N, 3, self.heads, head).permute(2, 0, 3, 1, 4)
        scale = scalar(head ** -0.5, q.dtype)
        kt = k.transpose(-2, -1)
        vf = v.to(x.dtype)
        if "attn" in facets or not query_chunk or query_chunk >= N:
            attn = torch.softmax(((q @ kt) * scale).float(), dim=-1).to(x.dtype)
            out = attn @ vf
        else:
            attn = None
            out = torch.cat([
                torch.softmax(((q[:, :, i:i + query_chunk] @ kt) * scale).float(),
                              dim=-1).to(x.dtype) @ vf
                for i in range(0, N, query_chunk)], dim=2)
        out = out.transpose(1, 2).reshape(B, N, D)
        x = x + linear(out, self.attn.proj, dt)
        y = gelu(linear(layer_norm(x, self.norm2, dt), self.mlp.fc1, dt))
        x = x + linear(y, self.mlp.fc2, dt)
        found = {"query": q, "key": k, "value": v, "attn": attn, "token": x}
        return x, {f: found[f] for f in facets}


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int, device="cuda"):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, device=device)


class DinoViT(nn.Module):
    """DINO ViT with a patch stride of its own (dense features)."""

    def __init__(self, patch: int = 8, width: int = 384, layers: int = 12, heads: int = 6,
                 stride: int = 4, compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.patch, self.width, self.stride = patch, width, stride
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.patch_embed = _PatchEmbed(patch, width, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (224 // patch) ** 2 + 1, width, device=device))
        self.blocks = nn.ModuleList(DinoBlock(width, heads, compute_dtype, device)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=1e-6, device=device)

    def grid(self, height: int, width: int) -> Tuple[int, int]:
        """The strided patch grid of an image: 1 + (side - patch) // stride."""
        return (1 + (height - self.patch) // self.stride,
                1 + (width - self.patch) // self.stride)

    def position_embedding(self, gh: int, gw: int) -> torch.Tensor:
        """[1, 1 + gh * gw, width]: the class position and the grid resized
        from 224 / patch to (gh, gw), each axis by its bicubic matrix."""
        n0 = int(math.sqrt(self.pos_embed.shape[1] - 1))
        pe = self.pos_embed[0, 1:].reshape(n0, n0, self.width)
        dev = pe.device
        if gh != n0:
            pe = torch.einsum("io,ijc->ojc", bicubic_resize_matrix(n0, gh, dev), pe)
        if gw != n0:
            pe = torch.einsum("jp,ojc->opc", bicubic_resize_matrix(n0, gw, dev), pe)
        return torch.cat([self.pos_embed[:, :1], pe.reshape(1, gh * gw, self.width)], dim=1)

    def forward(self, x: torch.Tensor, facet_layers: Sequence[int] = (11,),
                facets: Sequence[str] = FACETS, query_chunk: Optional[int] = None):
        """x [B, H, W, 3] normalized -> (normed tokens [B, 1 + gh * gw, D],
        {layer: {facet: tensor}} for ``facet_layers``, (gh, gw))."""
        dt = self.compute_dtype
        B, H, W, _ = x.shape
        conv = self.patch_embed.proj
        feat = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt),
                                          None, self.stride)
        feat = feat.float() + conv.bias[:, None, None]
        gh, gw = self.grid(H, W)
        tokens = feat.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, 1, self.width), tokens], dim=1)
        x = x + self.position_embedding(gh, gw)
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, blk in enumerate(self.blocks):
            x, found = blk(x, facets if i in facet_layers else (), query_chunk)
            if i in facet_layers:
                out[i] = found
        return layer_norm(x, self.norm, dt), out, (gh, gw)


def log_bin(desc: np.ndarray, num_patches: Tuple[int, int], hierarchy: int = 2) -> np.ndarray:
    """Hierarchical log-binned descriptor: desc [B, h, t, d] (CLS removed)
    -> [B, 1, t, d * h * (1 + 8 * hierarchy)].  Edge-padded 3^k box means
    by a cumulative sum over rows, then columns, as the JAX package sums,
    then each pixel's 3^k-spaced neighbours, clipped at the border."""
    B, h, t, d = desc.shape
    gh, gw = num_patches
    num_bins = 1 + 8 * hierarchy
    x = desc.transpose(0, 2, 1, 3).reshape(B, t, h * d)
    x = x.transpose(0, 2, 1).reshape(B, h * d, gh, gw)
    sub = h * d
    pools = []
    for k in range(hierarchy):
        win = 3 ** k
        pad = win // 2
        xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="edge")
        cs = np.pad(np.cumsum(np.cumsum(xp, axis=2), axis=3),
                    ((0, 0), (0, 0), (1, 0), (1, 0)))
        s = (cs[:, :, win:, win:] - cs[:, :, :-win, win:]
             - cs[:, :, win:, :-win] + cs[:, :, :-win, :-win])
        pools.append(s / (win * win))
    out = np.zeros((B, sub * num_bins, gh, gw), np.float32)
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    part = 0
    for k in range(hierarchy):
        ksz = 3 ** k
        for di in (-ksz, 0, ksz):
            for dj in (-ksz, 0, ksz):
                if di == 0 and dj == 0 and k != 0:
                    continue
                ii = np.clip(ys + di, 0, gh - 1)
                jj = np.clip(xs + dj, 0, gw - 1)
                out[:, part * sub:(part + 1) * sub] = pools[k][:, :, ii, jj]
                part += 1
    return out.reshape(B, sub * num_bins, gh * gw).transpose(0, 2, 1)[:, None]


def load_dino_state_dict(model: DinoViT, state: Mapping[str, torch.Tensor],
                         device="cuda") -> None:
    """Load a reference ``dino_vit*.pth`` state dict (its own key names;
    other keys, such as a classifier ``head``, are ignored) into ``model``
    as float32 tensors on ``device``; a missing key raises."""
    missing = [k for k in model.state_dict() if k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. {missing[0]}")
    model.load_state_dict({k: torch.as_tensor(state[k]).to(device, torch.float32)
                           for k in model.state_dict()}, strict=True, assign=True)


def seeded_dino_state_dict(model_type: str = "dino_vits8", seed: int = 0
                           ) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict of random weights from ``seed``: dense
    and conv weights lecun-normal, ``pos_embed`` and ``cls_token`` normal
    with std 0.02, norms ones, biases zeros (the layout and scales of a
    trained checkpoint, none of its values)."""
    from samnerf_tpu_torch.utils.init import init_state

    spec = _SPECS[model_type]
    return init_state(DinoViT(**spec, device="meta"),
                      torch.Generator().manual_seed(seed), "cpu")


class ViTExtractor:
    """Descriptor extraction with the reference ``ViTExtractor``'s API, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, model_type: str = "dino_vits8", stride: int = 4,
                 checkpoint: Optional[str] = None, seed: int = 0,
                 compute_dtype=torch.float32, query_chunk: Optional[int] = QUERY_CHUNK,
                 device="cuda"):
        spec = _SPECS[model_type]
        self.device = torch.device(device)
        self.model = DinoViT(**spec, stride=stride, compute_dtype=compute_dtype,
                             device="meta")
        self.layers = spec["layers"]
        self.p = spec["patch"]
        self.stride = (stride, stride)
        self.query_chunk = query_chunk
        self.num_patches = None
        state = (torch.load(checkpoint, map_location="cpu", weights_only=False)
                 if checkpoint is not None else seeded_dino_state_dict(model_type, seed))
        load_dino_state_dict(self.model, state, self.device)
        self.model.eval()

    def preprocess(self, image, load_size: Optional[int] = None) -> np.ndarray:
        """An image path or uint8 [H, W, 3] -> [1, H, W, 3] float32,
        ImageNet-normalised (in float64, then cast, as the JAX extractor's
        array reaches its device); ``load_size`` resizes the short side
        (Lanczos)."""
        from PIL import Image
        if isinstance(image, (str, Path)):
            image = np.asarray(Image.open(image).convert("RGB"))
        if load_size is not None:
            h, w = image.shape[:2]
            scale = load_size / min(h, w)
            image = np.asarray(Image.fromarray(image).resize(
                (int(w * scale), int(h * scale)), Image.LANCZOS))
        x = image.astype(np.float32) / 255.0
        x = (x - np.asarray(DINO_MEAN)) / np.asarray(DINO_STD)
        return x[None].astype(np.float32)

    @torch.no_grad()
    def extract_descriptors(self, batch: np.ndarray, layer: int = 11, facet: str = "key",
                            use_bin: bool = False, include_cls: bool = False) -> np.ndarray:
        """batch [B, H, W, 3] normalized -> [B, 1, t, d'] float32
        descriptors (t patches, CLS dropped unless ``include_cls``)."""
        x = torch.as_tensor(np.asarray(batch, np.float32), device=self.device)
        _, found, (gh, gw) = self.model(x, (layer,), (facet,), self.query_chunk)
        self.num_patches = (gh, gw)
        f = found[layer][facet].float()
        if facet == "token":
            f = f[:, None]
        if not include_cls:
            f = f[:, :, 1:]
        f = f.cpu().numpy()
        if use_bin:
            return log_bin(f, (gh, gw))
        B, h, t, d = f.shape
        return f.transpose(0, 2, 1, 3).reshape(B, t, h * d)[:, None]


def image_paths(image_path: Path):
    """The images to extract: the file itself, or a directory's image
    files in sorted order (a scene's ``images/`` when the directory itself
    holds none)."""
    image_path = Path(image_path)
    if not image_path.is_dir():
        return [image_path]
    paths = [p for p in sorted(image_path.iterdir()) if p.suffix.lower() in IMAGE_SUFFIXES]
    if not paths and (image_path / "images").is_dir():
        return image_paths(image_path / "images")
    return paths


def main(argv=None, device="cuda") -> None:
    p = argparse.ArgumentParser()
    p.add_argument("image_path", type=str)
    p.add_argument("--output-path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--model-type", type=str, default="dino_vits8")
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--layer", type=int, default=11)
    p.add_argument("--facet", type=str, default="key")
    p.add_argument("--load-size", type=int, default=None)
    p.add_argument("--bin", action="store_true")
    a = p.parse_args(argv)
    # f32 descriptors: no TF32 in the matmuls or in the cuDNN patch convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ex = ViTExtractor(a.model_type, a.stride, checkpoint=a.checkpoint, device=device)
    out_dir = Path(a.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    for ip in image_paths(Path(a.image_path)):
        batch = ex.preprocess(ip, a.load_size)
        desc = ex.extract_descriptors(batch, a.layer, a.facet, a.bin)
        desc = desc.reshape(ex.num_patches[0], ex.num_patches[1], -1)
        out = out_dir / (ip.stem + ".pt")
        torch.save(torch.from_numpy(np.ascontiguousarray(desc)), out)
        print(f"saved {out} {desc.shape}")


if __name__ == "__main__":
    main()
