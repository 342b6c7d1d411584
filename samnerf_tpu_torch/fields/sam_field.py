"""SAM / ClipSeg feature distillation field and the patch conv head,
counterpart of ``samnerf_tpu/fields/sam_field.py`` (the DINO head waits).
With ``hash_q8`` and ``fuse_mlp`` (serve only) each head's two pyramids
and its MLP run as one FUSED-QMLP launch."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.contraction import contract_to_unit
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.fields.mlp import MLP
from samnerf_tpu_torch.fields.nerfacto_field import _fused_encode_mlp, _mlp_is_fusable
from samnerf_tpu_torch.utils.dtypes import conv2d, resolve_dtype


class SAMField(nn.Module):
    """Two hash-grid pyramids per head feeding a 1-hidden-layer MLP:
    256-d SAM and 192-d ClipSeg embeddings at contracted points."""

    def __init__(self, grid_layers: Tuple[int, ...] = (12, 12),
                 grid_sizes: Tuple[int, ...] = (19, 19),
                 grid_resolutions: Tuple[Tuple[int, int], ...] = ((16, 128), (128, 512)),
                 features_per_level: int = 8, hidden_layers: int = 1,
                 hidden_dim: int = 256, sam_dim: int = 256,
                 clipseg_dim: int = 192, use_clipseg: bool = True,
                 hash_q8: bool = False, hash_fn: str = "reference",
                 quant_bits: int = 8, fuse_mlp: bool = False,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        # the fused kernel stacks pyramids of one table size
        self.fuse = hash_q8 and fuse_mlp and len(set(grid_sizes)) == 1

        def pyramids():
            return nn.ModuleList(
                ParityHashEncoding(
                    num_levels=grid_layers[i], min_res=grid_resolutions[i][0],
                    max_res=grid_resolutions[i][1],
                    log2_hashmap_size=grid_sizes[i],
                    features_per_level=features_per_level,
                    quantize_serve=hash_q8, quant_bits=quant_bits,
                    hash_fn=hash_fn, device=device)
                for i in range(len(grid_layers)))

        in_dim = sum(grid_layers) * features_per_level
        self.sam_enc = pyramids()
        self.sam_net = MLP(in_dim, hidden_dim, hidden_layers, sam_dim,
                           compute_dtype=compute_dtype, device=device)
        self.use_clipseg = use_clipseg
        if use_clipseg:
            self.clipseg_enc = pyramids()
            self.clipseg_net = MLP(in_dim, hidden_dim, 1, clipseg_dim,
                                   compute_dtype=compute_dtype, device=device)

    def forward(self, positions: torch.Tensor,
                get_features: Sequence[str] = ("sam", "clipseg"),
                live: Optional[torch.Tensor] = None) -> dict:
        """positions [R, K, 3] (world) -> dict of [R, K, C] features.

        ``live`` [R, K, 1] 0/1: samples with zero rendering weight get the
        sentinel position 0.5; their outputs are multiplied by zero
        weights downstream, so the weighted mean is exact."""
        flat = contract_to_unit(positions.detach()).reshape(-1, 3)
        if live is not None:
            flat = torch.where(live.reshape(-1, 1) > 0, flat, 0.5)

        def head(encs, net):
            if self.fuse and _mlp_is_fusable(net):
                h = _fused_encode_mlp(encs, net, flat)
            else:
                h = net(torch.cat([e(flat) for e in encs], dim=-1))
            return h.reshape(*positions.shape[:-1], h.shape[-1])

        out = {}
        if "sam" in get_features:
            out["sam"] = head(self.sam_enc, self.sam_net)
        if "clipseg" in get_features and self.use_clipseg:
            out["clipseg"] = head(self.clipseg_enc, self.clipseg_net)
        return out


class ConvHead(nn.Module):
    """Conv + ReLU + Conv over rendered SAM patches, then the spatial mean:
    [N, ps, ps, 256] (NHWC, as the JAX package) -> [N, 256] f32.  The
    convolutions run in ``compute_dtype`` (each as flax's ``nn.Conv``: the
    product rounded, then the bias added); the mean is taken in f32."""

    def __init__(self, kernel_size: int = 3, dim: int = 256,
                 compute_dtype=torch.float32, device="cuda"):
        super().__init__()
        pad = kernel_size // 2          # "SAME" for odd kernels
        self.convs = nn.ModuleList(
            nn.Conv2d(dim, dim, kernel_size, padding=pad, device=device)
            for _ in range(2))
        self.compute_dtype = resolve_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2)
        x = conv2d(torch.relu(conv2d(x, self.convs[0], dt)), self.convs[1], dt)
        return torch.mean(x.float(), dim=(-2, -1))
