"""The nerfacto radiance field and the proposal density field,
counterpart of ``samnerf_tpu/fields/nerfacto_field.py``.

The MLPs are pointwise, so points go to the encoders in their natural
[R*S] order (the JAX package's sample-major reorder only serves the TPU
scan).  The same code serves and trains: gradients reach the MLPs and,
through F32-ENC-BWD, the f32 hash tables; positions carry none.  With
``hash_q8`` and ``fuse_mlp`` (serve only) the encode and the base MLP run
as one FUSED-QMLP launch.  Serve-time culling (an occupancy grid,
``occ``, and early ray termination's ``live_in`` mask) moves dead points
to the sentinel 0.5 before the encode and zeroes their density; the grid
is tested per tile of the JAX package's point stream
(:func:`samnerf_tpu_torch.ops.occupancy.stream_tile_live`), so both
packages cull the same points.  Appearance embeddings (off in both
presets) wait.  ``compute_dtype`` sets the MLPs' type; the hash encodes
return f32, which the MLPs cast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from samnerf_tpu_torch.core.contraction import contract_to_unit
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.fields.mlp import MLP, trunc_exp
from samnerf_tpu_torch.ops.encodings import sh_encoding
from samnerf_tpu_torch.ops.hash_grid import parity_hash_encode_qmlp
from samnerf_tpu_torch.ops.occupancy import ServeOccupancy, stream_tile_live
from samnerf_tpu_torch.utils.dtypes import sigmoid


def _contract_and_select(positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contraction to [0, 1]^3 and the in-unit-cube selector; points
    outside are moved to the origin."""
    p = contract_to_unit(positions)
    selector = ((p > 0.0) & (p < 1.0)).all(dim=-1)
    return p * selector[..., None], selector


def _cull(p: torch.Tensor, occ: Optional[ServeOccupancy], occ_res: int,
          live_in: Optional[torch.Tensor] = None):
    """[R, S, 3] contracted points -> (flat [R*S, 3] with dead points at
    the sentinel 0.5, liveness [R, S, 1] or None when nothing culls).
    ``live_in`` [R, S, 1] is ANDed with the grid's tile test."""
    live = live_in
    if occ is not None and occ_res:
        grid = stream_tile_live(occ, p, occ_res)
        live = grid if live is None else live * grid
    flat = p.reshape(-1, 3)
    if live is not None:
        flat = torch.where(live.reshape(-1, 1) > 0, flat, 0.5)
    return flat, live


def _mlp_is_fusable(mlp: MLP) -> bool:
    """FUSED-QMLP computes exactly relu(x @ w1 + b1) @ w2 + b2 in f32, so
    a bf16 MLP serves unfused, as in the JAX package."""
    return (len(mlp.layers) == 2 and mlp.output_activation is None
            and mlp.compute_dtype == torch.float32)


def _fused_encode_mlp(encs, mlp: MLP, flat: torch.Tensor) -> torch.Tensor:
    """``mlp(cat([e(flat) for e in encs]))`` as one FUSED-QMLP call, on the
    baked serve tables of each encoding when it has them, else on its
    master quantized at max scale (``ParityHashEncoding.serve_table``).
    ``flat`` [N, 3] in [0, 1]; the pyramids must share their table size
    and width.  Serve only: no gradient."""
    num_steps, quant_bits = encs[0].num_steps, encs[0].quant_bits
    tables, scales = [], []
    for e in encs:
        if (e.num_steps, e.quant_bits) != (num_steps, quant_bits):
            raise ValueError("stacked pyramids must share their table size and width")
        table, sc = e.serve_table(quant_bits)
        tables.append(table)
        scales.append(sc)
    first, last = mlp.layers
    return parity_hash_encode_qmlp(
        tables, scales, flat.contiguous(), [e.scalings for e in encs], num_steps,
        first.weight.detach().t().contiguous(), first.bias.detach(),
        last.weight.detach().t().contiguous(), last.bias.detach(),
        hash_fn=encs[0].hash_fn, qbits=quant_bits)


class NerfactoField(nn.Module):
    """Density + view-dependent color field."""

    def __init__(self, num_layers: int = 2, hidden_dim: int = 64,
                 geo_feat_dim: int = 15, num_levels: int = 16,
                 max_res: int = 2048, log2_hashmap_size: int = 19,
                 num_layers_color: int = 3, hidden_dim_color: int = 64,
                 hash_q8: bool = False, hash_fn: str = "reference",
                 quant_bits: int = 8, fuse_mlp: bool = False,
                 compute_dtype=torch.float32, occ_res: int = 0, device="cuda"):
        super().__init__()
        self.fuse = hash_q8 and fuse_mlp
        self.occ_res = occ_res
        self.encoding = ParityHashEncoding(
            num_levels=num_levels, min_res=16, max_res=max_res,
            log2_hashmap_size=log2_hashmap_size, features_per_level=2,
            quantize_serve=hash_q8, quant_bits=quant_bits, hash_fn=hash_fn,
            device=device)
        self.mlp_base = MLP(self.encoding.out_dim, hidden_dim, num_layers - 1,
                            1 + geo_feat_dim, compute_dtype=compute_dtype,
                            device=device)
        self.mlp_head = MLP(16 + geo_feat_dim, hidden_dim_color,
                            num_layers_color - 1, 3,
                            output_activation=sigmoid,
                            compute_dtype=compute_dtype, device=device)

    def get_density(self, positions: torch.Tensor, occ: Optional[ServeOccupancy] = None,
                    live_in: Optional[torch.Tensor] = None):
        """[R, S, 3] -> (density [R, S, 1], geo_feat [R, S, geo]).  ``occ``
        (with ``occ_res``) and ``live_in`` [R, S, 1] 0/1 cull samples: they
        are encoded at the sentinel and their density is exactly 0."""
        p, selector = _contract_and_select(positions)
        flat, live = _cull(p, occ, self.occ_res, live_in)
        if self.fuse and _mlp_is_fusable(self.mlp_base):
            h = _fused_encode_mlp([self.encoding], self.mlp_base, flat)
        else:
            h = self.mlp_base(self.encoding(flat))
        h = h.reshape(*positions.shape[:-1], h.shape[-1])
        density = trunc_exp(h[..., :1]) * selector[..., None]
        if live is not None:
            density = density * live
        return density, h[..., 1:]

    def density_at_unit(self, p_unit: torch.Tensor) -> torch.Tensor:
        """[N, 3] contracted-unit points -> [N, 1] density, no selector:
        the occupancy bake's query (its points lie inside the cube)."""
        return trunc_exp(self.mlp_base(self.encoding(p_unit))[..., :1])

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                occ: Optional[ServeOccupancy] = None,
                live_in: Optional[torch.Tensor] = None) -> dict:
        """positions [R, S, 3], directions [R, 3] -> density, rgb; ``occ``
        and ``live_in`` as in :meth:`get_density`."""
        density, geo = self.get_density(positions, occ, live_in)
        d_enc = sh_encoding(directions)[..., None, :].expand(
            *positions.shape[:-1], 16)
        rgb = self.mlp_head(torch.cat([d_enc, geo], dim=-1))
        return {"density": density, "rgb": rgb}


class HashMLPDensityField(nn.Module):
    """Proposal density field."""

    def __init__(self, num_layers: int = 2, hidden_dim: int = 16,
                 num_levels: int = 5, max_res: int = 128, base_res: int = 16,
                 log2_hashmap_size: int = 13, features_per_level: int = 2,
                 hash_q8: bool = False, hash_fn: str = "reference",
                 quant_bits: int = 8, fuse_mlp: bool = False,
                 compute_dtype=torch.float32, occ_res: int = 0, device="cuda"):
        super().__init__()
        self.fuse = hash_q8 and fuse_mlp
        self.occ_res = occ_res
        self.encoding = ParityHashEncoding(
            num_levels=num_levels, min_res=base_res, max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level, quantize_serve=hash_q8,
            quant_bits=quant_bits, hash_fn=hash_fn, device=device)
        self.mlp = MLP(self.encoding.out_dim, hidden_dim, num_layers - 1, 1,
                       compute_dtype=compute_dtype, device=device)

    def forward(self, positions: torch.Tensor,
                occ: Optional[ServeOccupancy] = None) -> torch.Tensor:
        """[R, S, 3] -> density [R, S, 1]; ``occ`` culls as in
        :meth:`NerfactoField.get_density`."""
        p, selector = _contract_and_select(positions)
        flat, live = _cull(p, occ, self.occ_res)
        if self.fuse and _mlp_is_fusable(self.mlp):
            raw = _fused_encode_mlp([self.encoding], self.mlp, flat)
        else:
            raw = self.mlp(self.encoding(flat))
        density = trunc_exp(raw.reshape(*positions.shape[:-1], 1)) * selector[..., None]
        return density if live is None else density * live
