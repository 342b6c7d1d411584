"""The hash grids as modules, counterpart of
``samnerf_tpu/fields/hash_encoding.py``: ``ParityHashEncoding`` (the
Pallas kernels' layout, F32-ENC / Q-ENC here) and ``HashEncoding`` (the
flat feature-major table, plain PyTorch)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from samnerf_tpu_torch.ops import encodings as enc_ops
from samnerf_tpu_torch.ops.encodings import hash_grid_scalings
from samnerf_tpu_torch.ops.hash_grid import (LANES, PARITIES, hash_encode,
                                             interleave_packs, parity_hash_encode_q8,
                                             quantize_parity_table)


class HashEncoding(nn.Module):
    """Multiresolution hash grid over the flat table: parameter ``table``
    [F, L * 2^S] f32; positions [N, 3] in [0, 1] -> [N, F*L]
    (feature-major channels, :func:`samnerf_tpu_torch.ops.encodings.hash_encode`)."""

    def __init__(self, num_levels: int = 16, min_res: int = 16, max_res: int = 2048,
                 log2_hashmap_size: int = 19, features_per_level: int = 2,
                 device="cuda"):
        super().__init__()
        self.log2_hashmap_size = log2_hashmap_size
        self.scalings = tuple(hash_grid_scalings(num_levels, min_res, max_res).tolist())
        self.table = nn.Parameter(torch.empty(
            (features_per_level, num_levels << log2_hashmap_size), device=device))

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * len(self.scalings)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return enc_ops.hash_encode(self.table, positions, self.scalings,
                                   self.log2_hashmap_size)


class ParityHashEncoding(nn.Module):
    """Multiresolution hash grid over the parity table layout.

    Parameter ``table`` [P*L, steps*8, 128, 2] f32.  With
    ``quantize_serve`` the encode reads int8 (or int4, ``quant_bits``)
    tables: pre-baked ``qtable{b}`` / ``qscales{b}`` buffers when present
    (see ``SamNerfRenderer.bake_serve_tables``), else the masters
    quantized at max scale on every call, and no gradient reaches the
    table.  The kernels read each baked table in the serve layout of
    ``interleave_packs``, held beside it as the non-persistent buffer
    ``qserve{b}`` (made when the table is baked or loaded; the state dict
    keeps the packed layout).  The f32 path carries the table gradient
    (F32-ENC-BWD).  Output [N, F*L] f32, feature-major channels."""

    def __init__(self, num_levels: int = 16, min_res: int = 16,
                 max_res: int = 2048, log2_hashmap_size: int = 19,
                 features_per_level: int = 2, quantize_serve: bool = False,
                 quant_bits: int = 8, hash_fn: str = "reference",
                 device="cuda"):
        super().__init__()
        if features_per_level % 2:
            raise ValueError("features are packed in pairs")
        self.num_levels = num_levels
        self.quantize_serve = quantize_serve
        self.quant_bits = quant_bits
        self.hash_fn = hash_fn
        self.num_steps = max(1, (1 << log2_hashmap_size) // (PARITIES * LANES))
        self.scalings = tuple(
            hash_grid_scalings(num_levels, min_res, max_res).tolist())
        num_packed = features_per_level // 2
        self.table = nn.Parameter(torch.empty(
            (num_packed * num_levels, self.num_steps * PARITIES, LANES, 2),
            device=device))
        for b in (8, 4):
            self.register_buffer(f"qtable{b}", None)
            self.register_buffer(f"qscales{b}", None)
            self.register_buffer(f"qserve{b}", None, persistent=False)

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * 2

    def set_quantized(self, qbits: int, packed: torch.Tensor,
                      scales: torch.Tensor) -> None:
        """Adopt a baked table [P*L, rows_q, 128] and its scales at
        ``qbits``, with its serve-layout copy."""
        setattr(self, f"qtable{qbits}", packed)
        setattr(self, f"qscales{qbits}", scales)
        setattr(self, f"qserve{qbits}", interleave_packs(packed, self.num_levels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # baked serve tables are optional: adopt them when the state has them
        for b in (8, 4):
            for name in (f"qtable{b}", f"qscales{b}"):
                if prefix + name in state_dict:
                    setattr(self, name, torch.empty_like(
                        state_dict[prefix + name], device=self.table.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        for b in (8, 4):
            packed = getattr(self, f"qtable{b}")
            if prefix + f"qtable{b}" in state_dict and packed is not None:
                setattr(self, f"qserve{b}", interleave_packs(packed, self.num_levels))

    def serve_table(self, qbits: int):
        """(serve table [L, rows_q, 128, P], scales [P*L]) at ``qbits``: the
        baked ones, else the master quantized at max scale and interleaved
        in the same call.  No gradient."""
        table = getattr(self, f"qserve{qbits}")
        if table is not None:
            return table, getattr(self, f"qscales{qbits}")
        packed, scales = quantize_parity_table(self.table.detach(), qbits=qbits)
        return interleave_packs(packed, self.num_levels), scales

    def forward(self, positions: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """positions [N, 3] in [0, 1] -> [N, F*L].  ``live`` only pins the
        quantized path to int8, as the reference's live-masked kernels do;
        every point is encoded either way."""
        n = positions.shape[0]
        pad = (-n) % LANES
        if pad:
            positions = torch.cat(
                [positions, positions.new_full((pad, 3), 0.5)])
        positions = positions.contiguous()
        if self.quantize_serve:
            qb = self.quant_bits if live is None else 8
            table, scales = self.serve_table(qb)
            out = parity_hash_encode_q8(table, scales, positions, self.scalings,
                                        self.num_steps, hash_fn=self.hash_fn,
                                        qbits=qb)
        else:
            out = hash_encode(self.table, positions, self.scalings,
                              self.num_steps, self.hash_fn)
        return out[:n] if pad else out
