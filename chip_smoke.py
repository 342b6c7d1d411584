#!/usr/bin/env python3
"""Drive the PyTorch port (``samnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. build the CUDA kernels from ``samnerf_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once; the toolkit's release printed) and print
   ``ptxas``'s registers, spills and shared memory of the F32-ENC,
   F32-ENC-BWD, Q-ENC and FUSED-QMLP kernels (raises on a spill);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serve path's shapes (max abs error, time, bound), the
   quantized encodes on the pack-interleaved serve table, F32-ENC and the
   quantized encodes at uniform positions and at the positions one
   512x512 static frame feeds each encoder (captured once from the
   model's own forward), and F32-ENC's layout pass BF16-PACK against its
   plain version (bit for bit);
4. qmlp_kernel: FUSED-QMLP against its plain version at the four serve
   heads' shapes (proposal, nerfacto, SAM at q8 and q4, ClipSeg), at
   uniform and in-frame positions, beside the unfused route (Q-ENC per
   pyramid, then the port's ``MLP``);
   serve: full-width ``samnerf_distill`` 512x512 frames through
   ``SamNerfRenderer.serve_frame_fn`` (static preset) with f32 tables,
   baked int8 tables, and baked int8 tables served through FUSED-QMLP
   (``serve_fuse_mlp``), launch counts per frame (22 F32-ENC per f32
   frame, 19 FUSED-QMLP per fused frame); then a 64x64 frame of a
   small model on the card against the same frame on the CPU, where every
   kernel runs its plain version, for each of the three;
   view: ``SamNerfRenderer.render_view`` at 512x512, full width, int8
   fused, with a ``SamPredictor``: a click locked in 3D in view 0, three
   further cameras that re-project it, and one view with a crop box;
5. train_kernels: the encode backward F32-ENC-BWD against its plain
   version, and F32-ENC, at the three encode shapes of a
   ``samnerf_distill`` training step (16384 rays), at uniform positions
   and at the positions and cotangents of one full-width ``Trainer`` step
   (captured by ``profile_train.capture_step_encodes``), and
   F32-ENC-BWD's layout pass GRAD-DEINTERLEAVE against its plain version;
6. train: full-width ``samnerf_distill`` training steps on a synthetic
   512x512 scene through the port's ``Trainer`` (ms per step, rays/s,
   peak memory, launches per step: 6 F32-ENC and 6 F32-ENC-BWD, and the
   layout passes, counted apart; losses); then one train step of a
   small model on the card against the same step on the CPU (losses and
   gradients);
7. attn_kernel: FLASH-RELPOS against its plain version at SAM ViT-H's
   and ViT-B's global-attention shapes and a small ragged one (max abs
   error, time, bound, and ``scaled_dot_product_attention`` with the
   materialised bias as a yardstick);
8. encode: SAM ViT-H at full width (seeded weights, saved once as a
   reference-layout checkpoint and loaded through ``build_sam``) through
   ``SamPredictor.set_image`` on 512x512 frames (ms per image, peak
   memory, FLASH-RELPOS launches per image, click -> mask ms), and the
   kernel route's embedding against the plain route's; then a small
   encoder on the card against the same encoder on the CPU;
9. preprocess: ``python -m samnerf_tpu_torch.preprocessing
   .get_image_embeddings`` (its ``main``) with that checkpoint on a
   synthetic 24-image 512x512 scene, the port's feature loader on the
   files, and 3 ``Trainer`` steps on them;
10. one ``{"kernels": [...]}`` line (the f32 kernels' layout passes
   listed under ``passes`` beside the kernel that needs them), then
   ``{"ok": true, "device": ...}`` as the last line.

Float32 matmuls and convolutions run in full f32 (TF32 off) so the card
and the CPU compute the same function.  Exits non-zero without a result
when no CUDA device is present.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TOL_KERNEL = 1e-5               # features are O(0.5); a flipped index is O(0.1)
# FUSED-QMLP: the JAX kernel test's tolerance; the MLP sums in another
# order than the plain version's matmuls, the wide heads in 3xTF32
# (about 1e-6 relative)
TOL_QMLP = dict(rtol=1e-4, atol=1e-4)
# (name, points, pyramids as (levels, packs, min res, max res), log2 table
# size, hidden, out, qbits): the four serve heads at one call of a 512x512
# static frame (a 32768-ray chunk; the SAM grid's 32768 rays x 8 samples;
# the ClipSeg grid's 1024 rays x 8)
QMLP_SHAPES = [
    ("proposal", 1 << 21, [(5, 1, 16, 128)], 17, 16, 1, 8),
    ("nerfacto", 1 << 20, [(16, 1, 16, 2048)], 19, 64, 16, 8),
    ("sam", 1 << 18, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 256, 8),
    ("sam", 1 << 18, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 256, 4),
    ("clipseg", 8192, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 192, 8)]
FUSED_PER_FRAME = 19            # 8 proposal + 8 nerfacto + 2 SAM + 1 ClipSeg
F32_PER_FRAME = 22              # 8 proposal + 8 nerfacto + 2 x 2 SAM + 2 ClipSeg pyramids
F32_PER_STEP = 6                # proposal, nerfacto, 2 SAM and 2 ClipSeg pyramids
VIEW_SIZE = 512
VIEW_INTRIN = np.array([[400.0, 0.0, 256.0], [0.0, 400.0, 256.0], [0.0, 0.0, 1.0]])
TOL_FRAME = 1e-3                # f32 card vs CPU, sums taken in other orders
# table gradients: f32 atomics vs a bf16-rounded sum (one bf16 step is 2^-8)
TOL_TABLE_GRAD = dict(rtol=1e-2, atol=1e-4)
TOL_DENSE_GRAD = dict(rtol=1e-3, atol=1e-5)   # f32 sums in other orders
TOL_LOSS = 1e-4
TOL_RELU_MARGIN = 1e-6          # conv pre-activations must keep this far from 0
TRAIN_WARMUP, TRAIN_STEPS = 3, 30
# FLASH-RELPOS: outputs are softmax averages of O(1) values; f32 sums over
# the keys in another order differ by ~1e-6; a wrong key tile or bias
# index moves an output by 1e-2 or more
TOL_ATTN = 1e-4
# encoder embeddings (O(1) after the neck's LayerNorm2d): the kernel route
# against the plain route, and a card encoder against the CPU's; f32 sums
# in other orders through every later block
TOL_ENCODE = 1e-3
ENCODE_IMAGES = 6               # the first is the warm-up
# FLASH-RELPOS shapes (name, batch * heads, token grid h, w, head dim):
# SAM ViT-H's and ViT-B's global layers and a small ragged one
ATTN_SHAPES = [("vit_h", 16, 64, 64, 80), ("vit_b", 12, 64, 64, 64),
               ("ragged", 3, 12, 20, 20)]
SMALL_ENCODER = dict(img_size=256, patch_size=16, embed_dim=160, depth=4,
                     num_heads=2, mlp_ratio=4.0, out_chans=256, window_size=7,
                     global_attn_indexes=(2,), flash_min_tokens=256)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _touched_table_bytes(hg, positions, scalings, num_steps, hash_fn,
                         num_packed, qbits=0) -> int:
    """Bytes of table the encode must read: the distinct f32 entry pairs
    (8 B) or packed words (4 B) that these positions touch."""
    plan = hg._level_plan(scalings, num_steps)
    x, y, z = (positions[:, i][None] for i in range(3))
    s = torch.arange(8, device=positions.device)[:, None]
    total = 0
    for scale, dense, half in plan:
        lo, hi, _ = hg._corner_index_math(x, y, z, scale, dense, half, num_steps,
                                          s & 1, (s >> 1) & 1, (s >> 2) & 1,
                                          hash_fn)
        entry = (hi << 7) | lo
        if qbits:
            entry = entry >> (1 if qbits == 8 else 2)   # entries sharing a word
        total += torch.unique(entry * 8 + s).numel() * (4 if qbits else 8)
    return total * num_packed


def _bound(n, channels, table_bytes, pack_levels):
    """(bound_ms, bound_by): bytes (positions + outputs + touched table)
    over HBM rate vs operations (8 corners x 2 features x multiply-add)
    over the f32 rate."""
    nbytes = 12 * n + 4 * channels * n + table_bytes
    ops = n * pack_levels * 8 * 2 * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# encode kernels (name, levels, packs, log2 table size, points, min res, max
# res, the head whose frame positions it takes): the point counts of one
# 32768-ray chunk of the static preset
KERNEL_SHAPES = [("nerfacto", 16, 1, 19, 1 << 20, 16, 2048, "nerfacto"),
                 ("proposal", 5, 1, 17, 1 << 21, 16, 128, "proposal"),
                 ("sam_pyramid", 12, 4, 19, 1 << 18, 128, 512, "sam")]


def kernel_phase(dev, frame_pos):
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, L, P, log2, n_uniform, lo_res, hi_res, head in KERNEL_SHAPES:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo_res, hi_res).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        uniform = torch.rand((n_uniform, 3), generator=gen, device=dev)
        variants = [("f32", 0, h, "uniform") for h in ("morton", "reference")]
        variants += [("f32", 0, "morton", "frame")]
        variants += [(f"q{b}", b, "morton", where) for where in ("uniform", "frame")
                     for b in ((8,) if name == "proposal" else (8, 4))]
        for kind, qbits, hash_fn, where in variants:
            pos = uniform if where == "uniform" else frame_pos[head]
            n = pos.shape[0]
            if qbits:
                packed, scales = hg.quantize_parity_table(table, qbits=qbits)
                serve = hg.interleave_packs(packed, L)
                run = (lambda: hg.parity_hash_encode_q8(
                    serve, scales, pos, scalings, steps, hash_fn, qbits))
                plain = (lambda: hg._parity_hash_encode_q8_ref(
                    packed, scales, pos, scalings, steps, hash_fn, qbits))
                kernel = "Q-ENC"
            else:
                run = lambda: hg.parity_hash_encode(table, pos, scalings, steps, hash_fn)
                plain = lambda: hg.parity_hash_encode_ref(table, pos, scalings,
                                                          steps, hash_fn)
                kernel = "F32-ENC"
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not math.isfinite(err) or err > TOL_KERNEL:
                raise AssertionError(f"{kernel} {name} {kind} {hash_fn}: max abs "
                                     f"err {err} > {TOL_KERNEL}")
            del out, ref
            ms = _time_ms(run, reps=20)
            plain_ms = _time_ms(plain, reps=3, warmup=1)
            tb = _touched_table_bytes(hg, pos, scalings, steps, hash_fn, P, qbits)
            bound_ms, bound_by = _bound(n, P * 2 * L, tb, P * L)
            row = dict(kernel=kernel, shape=name, variant=kind, hash_fn=hash_fn,
                       positions=where, points=n, levels=L, packs=P, log2_table=log2,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       table_bytes_touched=tb)
            rows.append(row)
            print(f"kernel {kernel:7s} {name:11s} {kind:3s} {hash_fn:9s} {where:7s} "
                  f"N={n:8d} err={err:.3e} (tol {TOL_KERNEL:g}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, {tb / 1e6:.1f} MB table)",
                  flush=True)
        if P > 1:
            rows.append(_pass_row(
                "BF16-PACK", name, lambda: hg.pack_bf16_table(table, L),
                lambda: hg.interleave_packs(hg._bf16_words(table), L), table.numel() * 6))
        del table, uniform
    return rows


def _pass_row(kernel, shape, run, plain, nbytes):
    """A layout pass of the f32 kernels (a permutation) against its plain
    version, bit for bit, and its time; ``nbytes`` it must move."""
    out, ref = run(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"{kernel} {shape}: not its plain version bit for bit")
    del out, ref
    row = dict(kernel=kernel, shape=shape, max_abs_err=0.0, ms=_time_ms(run, reps=20),
               plain_ms=_time_ms(plain, reps=3, warmup=1),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    print(f"pass {kernel} {shape}: exact, ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
          f"bound_ms={row['bound_ms']:.4f} (bytes, {nbytes / 1e6:.0f} MB)", flush=True)
    return row


def qmlp_kernel_phase(dev, frame_pos):
    """FUSED-QMLP against its plain version at the serve heads' shapes
    (morton hash, tables U(-0.5, 0.5), weights N(0, 1/fan_in) and biases
    N(0, 0.1)), at uniform positions and at the head's in-frame positions,
    with the unfused route's time: Q-ENC per pyramid, the concatenation
    and the port's ``MLP``."""
    from samnerf_tpu_torch.fields.mlp import MLP
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for (name, n_uniform, spec, log2, h_dim, o_dim, qbits), where in (
            (shape, where) for shape in QMLP_SHAPES for where in ("uniform", "frame")):
        steps = (1 << log2) // 1024
        packed, scales, scalings = [], [], []
        for levels, packs, lo_res, hi_res in spec:
            table = hg.init_parity_table(gen, levels, steps, packs, scale=0.5, device=dev)
            pk, sc = hg.quantize_parity_table(table, qbits=qbits)
            packed.append(pk)
            scales.append(sc)
            scalings.append(tuple(hash_grid_scalings(levels, lo_res, hi_res).tolist()))
            del table
        serve = [hg.interleave_packs(pk, len(s)) for pk, s in zip(packed, scalings)]
        c_dim = sum(2 * p.shape[0] for p in packed)
        mlp = MLP(c_dim, h_dim, 1, o_dim, device=dev)
        with torch.no_grad():
            for layer in mlp.layers:
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen,
                                               device=dev) * layer.weight.shape[1] ** -0.5)
                layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen,
                                             device=dev) * 0.1)
        w1, w2 = (m.weight.detach().t().contiguous() for m in mlp.layers)
        b1, b2 = (m.bias.detach() for m in mlp.layers)
        pos = (torch.rand((n_uniform, 3), generator=gen, device=dev) if where == "uniform"
               else frame_pos[name])
        n = pos.shape[0]
        args = (scales, pos, scalings, steps, w1, b1, w2, b2, "morton", qbits)
        run = lambda: hg.parity_hash_encode_qmlp(serve, *args)
        plain = lambda: hg._parity_hash_encode_qmlp_ref(packed, *args)

        @torch.no_grad()
        def unfused():
            return mlp(torch.cat([hg.parity_hash_encode_q8(t, sc, pos, s, steps, "morton",
                                                           qbits)
                                  for t, sc, s in zip(serve, scales, scalings)], -1))

        out, ref, alt = run(), plain(), unfused()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ratio = _tol_ratio(out, ref, **TOL_QMLP)
        unfused_err = (alt - ref).abs().max().item()
        if not math.isfinite(ratio) or ratio > 1.0 or tuple(out.shape) != (n, o_dim):
            raise AssertionError(f"FUSED-QMLP {name} q{qbits}: max abs err {err}, "
                                 f"{ratio:.3f} x the tolerance {TOL_QMLP}")
        del out, ref, alt
        ms = _time_ms(run, reps=20)
        plain_ms = _time_ms(plain, reps=3, warmup=1)
        unfused_ms = _time_ms(unfused, reps=20)
        # bytes: positions read, the output written, the table words these
        # positions touch; operations: the encode's multiply-adds (8
        # corners x 2 features per (point, pack*level)) and the MLP's
        # 2 N (C H + H O)
        tb = sum(_touched_table_bytes(hg, pos, s, steps, "morton", pk.shape[0] // len(s),
                                      qbits) for pk, s in zip(packed, scalings))
        nbytes = 12 * n + 4 * o_dim * n + tb
        ops = n * (c_dim // 2) * 8 * 2 * 2 + 2 * n * (c_dim * h_dim + h_dim * o_dim)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        row = dict(kernel="FUSED-QMLP", shape=name, variant=f"q{qbits}", hash_fn="morton",
                   positions=where, points=n, pyramids=len(spec), channels=c_dim,
                   hidden=h_dim, out=o_dim,
                   max_abs_err=err, tol_ratio=ratio, ms=ms, plain_ms=plain_ms,
                   unfused_route_ms=unfused_ms, unfused_route_max_abs_err=unfused_err,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   gflop=ops / 1e9, table_bytes_touched=tb)
        rows.append(row)
        print(f"qmlp kernel FUSED-QMLP {name:8s} q{qbits} {where:7s} N={n:8d} "
              f"{c_dim}->{h_dim}->{o_dim} "
              f"err={err:.3e} ({ratio:.3f} x tol) ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"unfused_route_ms={unfused_ms:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row['gflop']:.2f} GFLOP, {tb / 1e6:.1f} MB table)",
              flush=True)
        del packed, serve, scales, pos, mlp
    return rows


# the hash kernels whose ptxas report is printed and held to no spills
RESOURCE_KERNELS = ("f32_encode_kernel", "f32_encode_bwd_kernel", "q_encode_kernel",
                    "qmlp_kernel")


def kernel_resources():
    """``ptxas``'s registers, spills and shared memory of F32-ENC,
    F32-ENC-BWD, Q-ENC and FUSED-QMLP, named by their template arguments;
    raises if one of them spills."""
    import re

    from samnerf_tpu_torch.ops import cuda_build

    rows = []
    for r in cuda_build.kernel_resources("hash_encode"):
        m = re.search(r"(%s)I((?:L[ib]\d+E)+)E" % "|".join(RESOURCE_KERNELS), r["kernel"])
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            rows.append(dict(r, name=f"{m.group(1)}<{args}>"))
    for r in rows:
        print(f"ptxas {r['name']:34s} {r['registers']:3d} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, stack "
              f"{r['stack']} B, static smem {r['static_smem']} B", flush=True)
    missing = [k for k in RESOURCE_KERNELS if not any(r["name"].startswith(k + "<")
                                                      for r in rows)]
    if missing:
        raise AssertionError(f"no ptxas report of {missing}")
    spills = [r["name"] for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spills:
        raise AssertionError(f"ptxas reports spills in {spills}")
    return rows


def _cameras(dev, i, h, w, focal):
    from samnerf_tpu_torch.core.cameras import Cameras
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:, 3] = [0.03 * i, -0.02 * i, 1.5 - 0.05 * i]
    return Cameras(camera_to_worlds=torch.as_tensor(c2w[None], device=dev),
                   fx=torch.tensor([[focal]], device=dev),
                   fy=torch.tensor([[focal]], device=dev),
                   cx=torch.tensor([[w / 2.0]], device=dev),
                   cy=torch.tensor([[h / 2.0]], device=dev), width=w, height=h)


# (tag, hash_q8_serve, serve_fuse_mlp) of the serve and reference runs
SERVE_RUNS = (("f32", False, False), ("int8", True, False), ("int8_fused", True, True))


def _reset_encode_launches(hg):
    hg.parity_hash_encode.launches = 0
    hg.parity_hash_encode_q8.launches = 0
    hg.parity_hash_encode_qmlp.launches = 0
    hg.parity_hash_encode_bwd.launches = 0
    hg.pack_bf16_table.launches = 0
    hg.deinterleave_table_grad.launches = 0


def _encode_launches(hg):
    return {"F32-ENC": hg.parity_hash_encode.launches,
            "Q-ENC": hg.parity_hash_encode_q8.launches,
            "FUSED-QMLP": hg.parity_hash_encode_qmlp.launches}


def _pass_launches(hg):
    """Launches of the f32 kernels' layout passes, counted apart."""
    return {"BF16-PACK": hg.pack_bf16_table.launches,
            "GRAD-DEINTERLEAVE": hg.deinterleave_table_grad.launches}


def serve_phase(dev):
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    H = W = 512
    # samnerf_distill at full width: 2^19 nerfacto (16 levels) and SAM /
    # ClipSeg pyramids (2 x 12 levels x 8 features), 2^17 proposal tables,
    # patch 4, morton hash; random weights from a seed
    cfg = SAMModelConfig(hash_fn="morton")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    clicks = [(256.0, 256.0), (100.0, 300.0), (400.0, 120.0), (320.0, 420.0),
              (60.0, 60.0), (480.0, 300.0)]
    results = {}
    for tag, q8, fuse in SERVE_RUNS:
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        serve = snr.serve_frame_fn(sam, H, W)
        frame = snr.renderer.render_image_device(_cameras(dev, 0, H, W, 400.0), 0,
                                                 W, H, ("sam", "clipseg"), minimal=True)
        for k, shape in (("rgb", (H, W, 3)), ("sam", (64, 64, 256)),
                         ("clipseg", (32, 32, 192))):
            v = frame[k]
            if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"serve grid {k}: {tuple(v.shape)} or not finite")
        del frame
        serve(_cameras(dev, 0, H, W, 400.0), 0, clicks[0])        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_encode_launches(hg)
        times = []
        for i, click in enumerate(clicks[1:], start=1):
            t0 = time.perf_counter()
            img = serve(_cameras(dev, i, H, W, 400.0), 0, click)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
                raise AssertionError(f"frame {img.dtype} {tuple(img.shape)}")
        frames = len(times)
        launches = _encode_launches(hg)
        passes = _pass_launches(hg)
        results[tag] = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                            frames=frames, launches=launches, pass_launches=passes,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"serve {tag:10s} 512x512 static: median frame "
              f"{results[tag]['frame_ms']:.2f} ms over {frames} frames "
              f"({', '.join(f'{t:.1f}' for t in times)}); launches/frame "
              + " ".join(f"{k}={v / frames:g}" for k, v in {**launches, **passes}.items())
              + f"; max_memory_allocated="
              f"{results[tag]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del model, snr, serve
    expect = {"f32": {"F32-ENC"}, "int8": {"Q-ENC"}, "int8_fused": {"FUSED-QMLP"}}
    for tag, kernels in expect.items():
        ran = {k for k, v in results[tag]["launches"].items() if v}
        if ran != kernels:
            raise AssertionError(f"the {tag} serve path launched {ran}, not {kernels}")
    for tag, kernel, per_frame in (("int8_fused", "FUSED-QMLP", FUSED_PER_FRAME),
                                   ("f32", "F32-ENC", F32_PER_FRAME)):
        r = results[tag]
        if r["launches"][kernel] != per_frame * r["frames"]:
            raise AssertionError(f"{kernel} launched {r['launches'][kernel]} times in "
                                 f"{r['frames']} frames, not {per_frame} per frame")
    return results


def reference_phase(dev):
    """A 64x64 frame of a small model (same seeded weights, tables at
    +-0.5 so features are far from zero) on the card vs on the CPU."""
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.utils.init import init_state

    cfg = SAMModelConfig(
        num_levels=8, max_res=256, log2_hashmap_size=14,
        num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
        proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                            "num_levels": 4, "max_res": 64},),
        hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
        hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=2, hash_fn="morton")
    from samnerf_tpu_torch.ops import hash_grid as hg

    report = {}
    for tag, q8, fuse in SERVE_RUNS:
        c = dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse)
        outs = {}
        _reset_encode_launches(hg)
        for d in (dev, "cpu"):
            params = init_state(SAMModel(c, device="meta"),
                                torch.Generator().manual_seed(1), device=d,
                                table_scale=0.5)
            model = SAMModel(c, device=d)
            model.load_state_dict(params)
            sam = Sam(device=d)
            sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(2), d))
            snr = SamNerfRenderer(model, chunk=1024, serve_preset="static")
            cams = _cameras(d, 1, 64, 64, 50.0)
            grids = snr.renderer.render_image_device(cams, 0, 64, 64,
                                                     ("sam", "clipseg"), minimal=True)
            img, mask = snr.serve_frame_fn(sam, 64, 64)(cams, 0, (20.0, 40.0),
                                                        return_mask=True)
            outs[str(d)] = {k: v.cpu() for k, v in grids.items()}
            outs[str(d)].update(img=img.cpu(), mask=mask.cpu())
        launches = _encode_launches(hg)
        ran = {k for k, v in launches.items() if v}
        if ran != {"f32": {"F32-ENC"}, "int8": {"Q-ENC"}, "int8_fused": {"FUSED-QMLP"}}[tag]:
            raise AssertionError(f"the small {tag} frame on the card launched {launches}")
        a, b = outs[str(dev)], outs["cpu"]
        errs = {k: (a[k] - b[k]).abs().max().item() for k in ("rgb", "sam", "clipseg")}
        agree = (a["mask"] == b["mask"]).float().mean().item()
        same = a["mask"] == b["mask"]
        img_err = (a["img"].int() - b["img"].int()).abs()[same].max().item()
        report[tag] = dict(grid_max_abs_err=errs, mask_agreement=agree,
                           frame_max_diff_outside_flips=img_err, launches=launches)
        print(f"reference {tag}: 64x64 card vs CPU grid max abs err {errs}, "
              f"mask agreement {agree:.5f}, frame max diff {img_err}", flush=True)
        if max(errs.values()) > TOL_FRAME or agree < 0.999 or img_err > 1:
            raise AssertionError(f"card and CPU frames disagree: {report[tag]}")
    return report


def view_phase(dev, cfg=None, size=VIEW_SIZE, chunk=1 << 15):
    """``render_view`` with baked int8 tables through FUSED-QMLP (full
    ``samnerf_distill`` width unless ``cfg`` is given): a click in view 0
    is locked in 3D, three further cameras re-project it, then one view
    with a crop box.  Raises if a locked pin that lies in bounds and in
    front of the depth is not drawn."""
    from samnerf_tpu_torch.engine.render_pipeline import (SamNerfRenderer,
                                                          cameras_from_intrin_c2w, project,
                                                          visible_mask)
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w

    cfg = cfg or SAMModelConfig(hash_fn="morton")
    cfg = dataclasses.replace(cfg, hash_q8_serve=True, serve_fuse_mlp=True)
    gen = torch.Generator().manual_seed(0)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_params(cfg, gen, device=dev))
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    snr = SamNerfRenderer(model, sam_predictor=SamPredictor(sam), chunk=chunk,
                          serve_preset="static")
    snr.bake_serve_tables()
    intrin = VIEW_INTRIN * (size / VIEW_SIZE)
    intrin[2, 2] = 1.0
    # a generic position (the visibility test divides by each axis of a
    # pin's ray); the random weights make a uniform fog, so the further
    # cameras step towards the locked point and then see it in front of
    # their depth
    p0 = np.array([1.2 * np.cos(0.3), 1.2 * np.sin(0.3), 0.45])
    views = [look_at_c2w(p0, np.zeros(3))]
    click = np.array([[float(int(0.45 * size)), float(int(0.55 * size))]])
    rows = []

    def view(i, points, **crop):
        c2w = views[i]
        cams = cameras_from_intrin_c2w(intrin, c2w, size, size, device=dev)
        _reset_encode_launches(hg)
        t0 = time.perf_counter()
        out = snr.render_view(cams, 0, intrin, c2w, points=points, **crop)
        ms = (time.perf_counter() - t0) * 1e3
        launches = _encode_launches(hg)
        for k in ("rgb", "depth", "masked_rgb"):
            if out[k].shape[:2] != (size, size) or not np.isfinite(out[k]).all():
                raise AssertionError(f"view {i} {k}: {out[k].shape} or not finite")
        pins = project(intrin, c2w, snr.prompts)
        legal = ((pins >= 0) & (pins < size)).all(-1)
        vis = visible_mask(pins[legal].astype(np.float64), snr.prompts[legal],
                           out["depth"], intrin, c2w)
        drawn = [bool((out["masked_rgb"][y, x] == [1.0, 0.0, 0.0]).all())
                 for x, y in pins[legal]]
        if not all(d for d, v in zip(drawn, vis) if v):
            raise AssertionError(f"view {i}: a visible locked pin is not drawn: pins "
                                 f"{pins.tolist()}, visible {vis.tolist()}, drawn {drawn}")
        changed = np.abs(out["masked_rgb"] - out["rgb"]).max(-1) > 1e-6
        row = dict(view=i, crop="crop_aabb" in crop, ms=ms, locked=len(snr.prompts),
                   pins=pins.tolist(), in_bounds=legal.tolist(), visible=vis.tolist(),
                   drawn=drawn, mask_fraction=float(changed.mean()), launches=launches)
        rows.append(row)
        print(f"view {i}{' crop' if row['crop'] else ''} {size}x{size}: {ms:.1f} ms, "
              f"{row['locked']} locked, pins {row['pins']} in bounds {row['in_bounds']} "
              f"visible {row['visible']} drawn {drawn}, mask covers "
              f"{100 * row['mask_fraction']:.1f} % of the frame; launches "
              + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
        if launches["FUSED-QMLP"] != FUSED_PER_FRAME or launches["Q-ENC"] \
                or launches["F32-ENC"]:
            raise AssertionError(f"view {i} launched {launches}")

    view(0, click)
    step = (snr.prompts[0] - p0) / np.linalg.norm(snr.prompts[0] - p0)
    for i in (1, 2, 3):
        views.append(look_at_c2w(p0 + 0.05 * i * step + [0.0, 0.0, 0.02 * i], np.zeros(3)))
        view(i, click)
    view(0, click, crop_aabb=np.array([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]]),
         crop_bg=np.array([0.0, 0.0, 1.0]))
    if len(snr.prompts) != 1 or not all(r["drawn"] == [True] for r in rows[:4]):
        raise AssertionError("the click is not locked as one point drawn in view 0 and "
                             f"the three further views: {rows[:4]}")
    timed = [r["ms"] for r in rows[1:4]]
    result = dict(views=rows, view_ms=statistics.median(timed), view_ms_all=timed,
                  click_view_ms=rows[0]["ms"], crop_view_ms=rows[4]["ms"],
                  launches_per_view=FUSED_PER_FRAME,
                  launches=sum(r["launches"]["FUSED-QMLP"] for r in rows))
    print(f"view: median {result['view_ms']:.1f} ms per moved view "
          f"({', '.join(f'{t:.1f}' for t in timed)}), click view {rows[0]['ms']:.1f} ms, "
          f"crop view {rows[4]['ms']:.1f} ms; FUSED-QMLP {FUSED_PER_FRAME} launches per "
          f"view", flush=True)
    del snr, model, sam
    return result


def _tol_ratio(out, ref, rtol, atol) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 inside the tolerance."""
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


# the encodes of a training step (name, levels, packs, log2 table size,
# uniform points, min res, max res): one 16384-ray step
TRAIN_SHAPES = [("proposal", 5, 1, 17, 16384 * 64, 16, 128),
                ("nerfacto", 16, 1, 19, 16384 * 32, 16, 2048),
                ("sam_pyramid", 12, 4, 19, 16384 * 16, 128, 512)]


def train_kernel_phase(dev, step_calls):
    """F32-ENC-BWD against its plain backward, and both encode kernels'
    times, at the encodes of one 16384-ray training step: at uniform
    positions with N(0, 1) cotangents (a tenth of the rows zero, as
    outside points' are), and at the positions and cotangents of the
    first encode of the shape in a full-width ``Trainer`` step
    (``step_calls``, ``profile_train.capture_step_encodes``)."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, L, P, log2, n_uniform, lo_res, hi_res in TRAIN_SHAPES:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo_res, hi_res).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        pos = torch.rand((n_uniform, 3), generator=gen, device=dev)
        g = torch.randn((n_uniform, P * 2 * L), generator=gen, device=dev)
        g *= (torch.rand((n_uniform,), generator=gen, device=dev) >= 0.1)[:, None]
        step = next(c for c in step_calls if c["levels"] == L and c["packs"] == P
                    and c["num_steps"] == steps and np.allclose(c["scalings"], scalings))
        cases = [("uniform", h, pos, g) for h in ("morton", "reference")]
        cases.append(("step", step["hash_fn"], step["positions"], step["cotangent"]))
        table_bytes = table.numel() * 4
        for where, hash_fn, pos, g in cases:
            n = pos.shape[0]
            live = g.ne(0).any(dim=1)
            run = lambda: hg.parity_hash_encode_bwd(g, pos, scalings, steps, hash_fn)
            plain = lambda: hg.parity_hash_encode_bwd_ref(g, pos, scalings, steps, hash_fn)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ratio = _tol_ratio(out, ref, **TOL_TABLE_GRAD)
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(f"F32-ENC-BWD {name} {hash_fn} {where}: max abs err "
                                     f"{err}, {ratio:.3f} x the tolerance {TOL_TABLE_GRAD}")
            del out, ref
            ms = _time_ms(run, reps=20)
            plain_ms = _time_ms(plain, reps=3, warmup=1)
            # bytes the function must move: positions and cotangent read
            # once, the dense gradient table written once; operations: a
            # multiply-add per corner and feature of each live (point,
            # level).  The atomics' read-modify-write of each touched entry
            # is a cost of this design, not of the function, and is
            # reported apart (``atomic_rmw_bytes``)
            tb = _touched_table_bytes(hg, pos[live], scalings, steps, hash_fn, P)
            nbytes = 12 * n + 4 * P * 2 * L * n + table_bytes
            ops = int(live.sum().item()) * P * L * 8 * 2 * 2
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            fwd = lambda: hg.parity_hash_encode(table, pos, scalings, steps, hash_fn)
            fwd_err = (fwd() - hg.parity_hash_encode_ref(table, pos, scalings, steps,
                                                         hash_fn)).abs().max().item()
            if not math.isfinite(fwd_err) or fwd_err > TOL_KERNEL:
                raise AssertionError(f"F32-ENC {name} {hash_fn} {where}: max abs err "
                                     f"{fwd_err} > {TOL_KERNEL}")
            fwd_ms = _time_ms(fwd, reps=20)
            ftb = _touched_table_bytes(hg, pos, scalings, steps, hash_fn, P)
            fwd_bound_ms, fwd_bound_by = _bound(n, P * 2 * L, ftb, P * L)
            row = dict(kernel="F32-ENC-BWD", shape=name, hash_fn=hash_fn, positions=where,
                       points=n, live_points=int(live.sum().item()), levels=L, packs=P,
                       log2_table=log2, max_abs_err=err,
                       tol_ratio=ratio, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, table_bytes_touched=tb,
                       atomic_rmw_bytes=2 * tb,
                       atomic_rmw_ms=2 * tb / HBM_BYTES_PER_S * 1e3, fwd_ms=fwd_ms,
                       fwd_max_abs_err=fwd_err, fwd_bound_ms=fwd_bound_ms,
                       fwd_bound_by=fwd_bound_by)
            rows.append(row)
            print(f"train kernel {name:11s} {hash_fn:9s} {where:7s} N={n:8d} F32-ENC-BWD "
                  f"err={err:.3e} ({ratio:.3f} x tol) ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}); F32-ENC err={fwd_err:.3e} "
                  f"ms={fwd_ms:.4f} bound_ms={fwd_bound_ms:.4f}", flush=True)
        if P > 1:
            scratch = torch.randn((L, steps * 8, 128, P, 2), generator=gen, device=dev)
            rows.append(_pass_row(
                "GRAD-DEINTERLEAVE", name, lambda: hg.deinterleave_table_grad(scratch),
                lambda: scratch.permute(3, 0, 1, 2, 4).reshape(table.shape),
                2 * table_bytes))
            del scratch
        del table, pos, g
    return rows


def train_phase(dev):
    """Full-width samnerf_distill training steps on a synthetic 512x512
    scene: 24 train images, SAM maps 64x64x256, ClipSeg maps 32x32x192."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts.profile_train import build_synthetic_trainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_synthetic_trainer(Path(tmp), dev)
        losses, times, t_prev = [], [], [0.0]

        def on_step(step, metrics):
            # counts, peak memory and step times cover the steps after warm-up
            losses.append({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            now = time.perf_counter()
            if step == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
                _reset_encode_launches(hg)
            elif step > TRAIN_WARMUP:
                times.append((now - t_prev[0]) * 1e3)
            t_prev[0] = now

        trainer.cfg.max_num_iterations = TRAIN_WARMUP + TRAIN_STEPS
        trainer.train(step_callback=on_step)
        launches = {"F32-ENC": hg.parity_hash_encode.launches,
                    "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                    "Q-ENC": hg.parity_hash_encode_q8.launches}
        passes = _pass_launches(hg)
        peak = torch.cuda.max_memory_allocated()
        rays = trainer.datamanager.config.train_num_rays_per_batch
        del trainer
    step_ms = statistics.median(times)
    rgb = [m["rgb_loss"] for m in losses]
    result = dict(step_ms=step_ms, step_ms_all=times, rays_per_s=rays / step_ms * 1e3,
                  steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, launches=launches,
                  pass_launches=passes,
                  launches_per_step={k: v / TRAIN_STEPS
                                     for k, v in {**launches, **passes}.items()},
                  max_memory_allocated=peak, first_losses=losses[0],
                  last_losses=losses[-1], rgb_loss=rgb)
    print(f"train samnerf_distill {rays} rays/step: median step {step_ms:.2f} ms over "
          f"{TRAIN_STEPS} steps ({min(times):.1f}-{max(times):.1f}), "
          f"{result['rays_per_s']:,.0f} rays/s; launches/step "
          + ", ".join(f"{k}={v:g}" for k, v in result["launches_per_step"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB", flush=True)
    print(f"train losses first {losses[0]}\ntrain losses last {losses[-1]}", flush=True)
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError("a training loss is not finite")
    if not statistics.mean(rgb[-5:]) < statistics.mean(rgb[:5]):
        raise AssertionError(f"rgb loss did not fall: {rgb}")
    if launches["F32-ENC"] != F32_PER_STEP * TRAIN_STEPS \
            or launches["F32-ENC-BWD"] != F32_PER_STEP * TRAIN_STEPS:
        raise AssertionError(f"the train path launched {launches} in {TRAIN_STEPS} steps, "
                             f"not {F32_PER_STEP} + {F32_PER_STEP} per step")
    if launches["Q-ENC"]:
        raise AssertionError("the train path ran a quantized encode")
    return result


def train_reference_phase(dev):
    """One train step of a small model (seeded weights, tables at +-0.5,
    a fixed batch and jitter) on the card vs on the CPU, where every
    kernel runs its plain version: losses and every parameter gradient.
    A ReLU input within float noise of 0 may open on one device and not
    the other, and in the conv head, whose weight gradient sums few terms,
    that moves a gradient beyond the tolerance; the batch seed is one whose
    conv pre-activations keep more than TOL_RELU_MARGIN from 0 on both
    devices, and the phase checks that margin before the gradients."""
    from samnerf_tpu_torch.data.device_data import indices_from_uniform, uniform_shape
    from samnerf_tpu_torch.engine.trainer import TrainState, loss_and_grads
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
    from samnerf_tpu_torch.utils.init import init_state

    cfg = SAMModelConfig(
        num_levels=8, max_res=256, log2_hashmap_size=14,
        num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
        proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                            "num_levels": 4, "max_res": 64},),
        hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
        hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=2, hash_fn="morton")
    rays = 256
    rng = np.random.default_rng(8)
    u = torch.from_numpy(rng.random(uniform_shape(rays, 2)))
    batch = {"indices": indices_from_uniform(u, 1, 64, 64, 2).numpy(),
             "image": rng.uniform(size=(rays, 3)).astype(np.float32),
             "sam": rng.normal(size=(rays // 4, 256)).astype(np.float32),
             "clipseg": rng.normal(size=(rays, 192)).astype(np.float32)}
    jitter = [rng.uniform(size=(rays, 1)).astype(np.float32) for _ in range(2)]
    outs, margin = {}, []
    for d in (dev, "cpu"):
        model = SAMModel(cfg, device=d)
        model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                         torch.Generator().manual_seed(1), device=d,
                                         table_scale=0.5))
        model.conv.convs[0].register_forward_hook(
            lambda m, i, o: margin.append(o.detach().abs().min().item()))
        ld, _, _ = loss_and_grads(
            model, cfg, TrainState(step=3), _cameras(d, 1, 64, 64, 50.0),
            {k: torch.as_tensor(v, device=d) for k, v in batch.items()},
            ("sam", "clipseg"), jitter=[torch.as_tensor(j, device=d) for j in jitter])
        outs[str(d)] = ({k: v.item() for k, v in ld.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()})
    if min(margin) <= TOL_RELU_MARGIN:
        raise AssertionError(
            f"a conv pre-activation lies {min(margin):.2e} from 0 (card {margin[0]:.2e}, "
            f"CPU {margin[-1]:.2e}): its ReLU may open on one device only, so the "
            "gradients cannot be compared; pick another batch seed")
    (la, ga), (lb, gb) = outs[str(dev)], outs["cpu"]
    loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb)
    ratios = {n: _tol_ratio(ga[n], gb[n], **(TOL_TABLE_GRAD if n.endswith("table")
                                             else TOL_DENSE_GRAD)) for n in gb}
    worst = max(ratios, key=ratios.get)
    report = dict(loss_max_rel_err=loss_err, losses=la, grad_tol_ratio=ratios,
                  worst=worst, conv_relu_margin_card=margin[0],
                  conv_relu_margin_cpu=margin[-1])
    print(f"train reference: card vs CPU step, losses max rel err {loss_err:.2e} "
          f"(tol {TOL_LOSS:g}); gradients within {ratios[worst]:.3f} x tol at worst "
          f"({worst}); conv ReLU margin {margin[0]:.2e} on the card, "
          f"{margin[-1]:.2e} on the CPU", flush=True)
    if loss_err > TOL_LOSS or not all(math.isfinite(r) and r <= 1.0
                                      for r in ratios.values()):
        raise AssertionError(f"card and CPU train steps disagree: {report}")
    return report


def attn_kernel_phase(dev):
    """FLASH-RELPOS against its plain version.  q, k, v ~ N(0, 1), as a
    seeded layer's LayerNorm and lecun-normal qkv give them; rel-pos
    tables N(0, 0.02) (``init_state``) contracted with q by the encoder's
    own ``decomposed_rel_terms``."""
    import torch.nn.functional as F

    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.image_encoder import decomposed_rel_terms

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for name, b, gh, gw, d in ATTN_SHAPES:
        n = gh * gw
        q, k, v = (torch.randn((b, n, d), generator=gen, device=dev) for _ in range(3))
        tables = [torch.randn((2 * s - 1, d), generator=gen, device=dev) * 0.02
                  for s in (gh, gw)]
        rel_h, rel_w = decomposed_rel_terms(q, *tables, (gh, gw), (gh, gw))
        rel_h = rel_h.reshape(b, n, gh).contiguous()
        rel_w = rel_w.reshape(b, n, gw).contiguous()
        scale = d ** -0.5
        run = lambda: ta.flash_attention_relpos(q, k, v, rel_h, rel_w, scale)
        plain = lambda: ta.reference_attention_relpos(q, k, v, rel_h, rel_w, scale)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not math.isfinite(err) or err > TOL_ATTN:
            raise AssertionError(f"FLASH-RELPOS {name}: max abs err {err} > {TOL_ATTN}")
        # the yardstick: one PyTorch call on the same inputs, the bias
        # materialised beforehand as its attn_mask
        bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, n, n)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                         scale=scale)
        library_err = (library() - ref).abs().max().item()
        del out, ref
        ms = _time_ms(run, reps=20)
        plain_ms = _time_ms(plain, reps=5)
        library_ms = _time_ms(library, reps=5)
        del bias
        # operations: q.k and p.v, a multiply-add per (query, key, dim)
        # each; bytes: q, k, v, rel_h, rel_w read once, the output written
        flops = 4 * b * n * n * d
        nbytes = 4 * (4 * b * n * d + b * n * (gh + gw))
        t_ops, t_bytes = flops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        row = dict(kernel="FLASH-RELPOS", shape=name, heads=b, tokens=n, head_dim=d,
                   grid=(gh, gw), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_max_abs_err=library_err,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflops=flops / ms / 1e9)
        rows.append(row)
        print(f"attn kernel FLASH-RELPOS {name:6s} B={b:2d} N={n:5d} D={d:2d} "
              f"err={err:.3e} (tol {TOL_ATTN:g}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={library_ms:.3f} (err {library_err:.1e}) "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}), "
              f"{row['tflops']:.1f} TFLOP/s", flush=True)
        del q, k, v, rel_h, rel_w
    return rows


def vit_h_checkpoint(dev, path: Path) -> None:
    """Seeded ViT-H SAM weights (``init_state``, drawn on the card) saved
    once in the reference torch SAM's key layout."""
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam
    from samnerf_tpu_torch.utils.init import init_state

    state = init_state(build_sam("vit_h", device="meta"),
                       torch.Generator(device=dev).manual_seed(3), device="cpu")
    torch.save(state, path)
    print(f"vit_h checkpoint: {sum(t.numel() for t in state.values()) / 1e6:.1f} M "
          f"parameters, {path.stat().st_size / 2**30:.2f} GiB", flush=True)


def _scene_images(scene: Path):
    from PIL import Image
    return [np.asarray(Image.open(p).convert("RGB"))
            for p in sorted((scene / "images").glob("*.png"))]


def encode_phase(dev, checkpoint: Path, images):
    """ViT-H through ``SamPredictor.set_image``: ms per image over distinct
    512x512 frames after a warm-up, peak memory, FLASH-RELPOS launches per
    image, click -> mask ms; then one image through the plain route
    (``use_flash=False``, the same weights) against the kernel route."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    sam = build_sam("vit_h", checkpoint=str(checkpoint), device=dev)
    predictor = SamPredictor(sam)
    predictor.set_image(images[0])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ta.flash_attention_relpos.launches = 0
    times = []
    for img in images[1:ENCODE_IMAGES]:
        t0 = time.perf_counter()
        predictor.set_image(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        emb = predictor.get_image_embedding()
        if tuple(emb.shape) != (1, 64, 64, 256) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"embedding {tuple(emb.shape)} or not finite")
    launches = ta.flash_attention_relpos.launches
    peak = torch.cuda.max_memory_allocated()
    images_timed = len(times)
    if launches != 4 * images_timed:
        raise AssertionError(f"FLASH-RELPOS launched {launches} times for "
                             f"{images_timed} ViT-H images, not 4 per image")
    clicks = [(256.0, 256.0), (100.0, 300.0), (400.0, 120.0), (320.0, 420.0),
              (60.0, 60.0), (480.0, 300.0)]
    click_ms = []
    for i, click in enumerate(clicks):
        t0 = time.perf_counter()
        masks, iou, low = predictor.predict(point_coords=np.array([click]),
                                            point_labels=np.array([1]))
        if i:                                            # the first is the warm-up
            click_ms.append((time.perf_counter() - t0) * 1e3)
        if masks.shape != (3, 512, 512) or low.shape != (3, 256, 256) \
                or not np.isfinite(low).all() or not np.isfinite(iou).all():
            raise AssertionError(f"predict: masks {masks.shape}, low-res {low.shape}")
    kernel_emb = predictor.get_image_embedding().clone()
    plain = build_sam("vit_h", device="meta")
    plain.load_state_dict(sam.state_dict(), assign=True)
    for block in plain.image_encoder.blocks:
        block.attn.use_flash = False
    plain_predictor = SamPredictor(plain)
    plain_predictor.set_image(images[ENCODE_IMAGES - 1])     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain_predictor.set_image(images[ENCODE_IMAGES - 1])
    torch.cuda.synchronize()
    plain_image_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = torch.cuda.max_memory_allocated()
    if ta.flash_attention_relpos.launches != launches:
        raise AssertionError("the plain route launched FLASH-RELPOS")
    route_err = (kernel_emb - plain_predictor.get_image_embedding()).abs().max().item()
    result = dict(image_ms=statistics.median(times), image_ms_all=times,
                  images=images_timed, launches=launches,
                  launches_per_image=launches / images_timed,
                  max_memory_allocated=peak, click_ms=statistics.median(click_ms),
                  click_ms_all=click_ms, plain_image_ms=plain_image_ms,
                  plain_max_memory_allocated=plain_peak, route_max_abs_err=route_err,
                  embedding_absmax=kernel_emb.abs().max().item())
    print(f"encode vit_h 512x512 -> 1024x1024: median {result['image_ms']:.2f} ms/image "
          f"over {images_timed} images ({', '.join(f'{t:.1f}' for t in times)}); "
          f"FLASH-RELPOS launches/image {launches / images_timed:g}; "
          f"max_memory_allocated={peak / 2**30:.2f} GiB; click -> mask median "
          f"{result['click_ms']:.2f} ms; plain route {plain_image_ms:.2f} ms/image, "
          f"{plain_peak / 2**30:.2f} GiB; kernel vs plain route embedding max abs err "
          f"{route_err:.3e} (tol {TOL_ENCODE:g}, |emb| max "
          f"{result['embedding_absmax']:.2f})", flush=True)
    if not math.isfinite(route_err) or route_err > TOL_ENCODE:
        raise AssertionError(f"kernel and plain routes disagree: {route_err}")
    del sam, plain, predictor, plain_predictor
    return result


def encode_reference_phase(dev):
    """A small encoder (4 blocks, 16x16 tokens, head dim 80, one global
    layer over FLASH-RELPOS, the windows plain) on the card against the
    same seeded encoder on the CPU, where the wrapper runs the plain
    version."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
    from samnerf_tpu_torch.utils.init import init_state

    x = np.random.default_rng(9).normal(size=(1, 256, 256, 3)).astype(np.float32)
    outs = {}
    for d in (dev, "cpu"):
        enc = ImageEncoderViT(**SMALL_ENCODER, device=d)
        enc.load_state_dict(init_state(ImageEncoderViT(**SMALL_ENCODER, device="meta"),
                                       torch.Generator().manual_seed(5), device=d))
        before = ta.flash_attention_relpos.launches
        with torch.no_grad():
            outs[str(d)] = enc(torch.as_tensor(x, device=d)).cpu()
        launches = ta.flash_attention_relpos.launches - before
        if launches != (1 if d == dev else 0):
            raise AssertionError(f"small encoder on {d}: {launches} FLASH-RELPOS launches")
    err = (outs[str(dev)] - outs["cpu"]).abs().max().item()
    print(f"encode reference: small encoder card vs CPU max abs err {err:.3e} "
          f"(tol {TOL_ENCODE:g})", flush=True)
    if not math.isfinite(err) or err > TOL_ENCODE:
        raise AssertionError(f"card and CPU encoders disagree: {err}")
    return dict(max_abs_err=err)


def preprocess_phase(dev, checkpoint: Path, root: Path):
    """The feature-extraction entry point on a synthetic 512x512 scene (24
    train images), the port's feature loader on its files, and 3 trainer
    steps distilling them."""
    import shutil

    from samnerf_tpu_torch.data.feature_loader import load_features
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.preprocessing import get_image_embeddings
    from samnerf_tpu_torch.scripts.profile_train import build_trainer
    from samnerf_tpu_torch.utils.synthetic import write_scene

    scene = write_scene(root / "scene", num_train=24, num_test=0, h=512, w=512,
                        with_features=True, feature_long_side=64)
    shutil.rmtree(scene / "sam_features")        # the synthetic targets
    ta.flash_attention_relpos.launches = 0
    t0 = time.perf_counter()
    get_image_embeddings.main([str(scene), "--checkpoint", str(checkpoint)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ta.flash_attention_relpos.launches
    files = sorted((scene / "sam_features").glob("*.npy"))
    if len(files) != 24 or launches != 4 * 24:
        raise AssertionError(f"{len(files)} feature files, {launches} FLASH-RELPOS launches")
    feats = load_features(files)
    if feats.shape != (24, 64, 64, 256) or feats.dtype != np.float32 \
            or not np.isfinite(feats).all():
        raise AssertionError(f"features {feats.shape} {feats.dtype} or not finite")
    trainer = build_trainer(scene, root / "out", dev)
    if not np.array_equal(trainer.datamanager.sam_features, feats):
        raise AssertionError("the trainer's SAM targets are not the extracted features")
    losses = []
    trainer.cfg.max_num_iterations = 3
    trainer.train(step_callback=lambda step, m: losses.append(
        {k: float(v) for k, v in m.items()}))
    del trainer
    if len(losses) != 3 or not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train steps on the extracted features: {losses}")
    result = dict(files=len(files), seconds=seconds, launches=launches,
                  feature_std=float(feats.std()), losses=losses)
    print(f"preprocess: get_image_embeddings wrote {len(files)} [256, 64, 64] f32 files "
          f"in {seconds:.1f} s ({launches} FLASH-RELPOS launches); 3 train steps on them, "
          f"sam_loss {losses[0].get('sam_loss', float('nan')):.4f} -> "
          f"{losses[-1].get('sam_loss', float('nan')):.4f}", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from samnerf_tpu_torch.ops import cuda_build
    from samnerf_tpu_torch.scripts.bench_encode import capture_frame_positions
    from samnerf_tpu_torch.scripts.profile_train import capture_step_encodes
    from samnerf_tpu_torch.utils.synthetic import write_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    nvcc = cuda_build.nvcc_version()
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({nvcc})", flush=True)

    resources = kernel_resources()
    frame_pos = capture_frame_positions(dev)     # scripts/bench_encode.py
    rows = kernel_phase(dev, frame_pos)
    qmlp_rows = qmlp_kernel_phase(dev, frame_pos)
    del frame_pos
    step_calls = capture_step_encodes(dev)
    train_rows = train_kernel_phase(dev, step_calls)
    del step_calls
    serve = serve_phase(dev)
    reference = reference_phase(dev)
    view = view_phase(dev)
    train = train_phase(dev)
    train_reference = train_reference_phase(dev)
    attn_rows = attn_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        checkpoint = root / "sam_vit_h_seeded.pth"
        vit_h_checkpoint(dev, checkpoint)
        frames = _scene_images(write_scene(root / "frames", num_train=ENCODE_IMAGES,
                                           num_test=0, h=512, w=512))
        encode = encode_phase(dev, checkpoint, frames)
        encode_reference = encode_reference_phase(dev)
        preprocess = preprocess_phase(dev, checkpoint, root)

    source = "samnerf_tpu_torch/csrc/hash_encode.cu"
    kernels = []
    # the nerfacto shape with the morton hash stands for each kernel: the
    # largest encode per launch of its main path; ``launches`` is the count
    # on that path (a serve run for the forward kernels, the timed train
    # steps for the backward), ``launches_by_path`` every path's count
    for name, replaces, run in (("F32-ENC", "samnerf_tpu/ops/hash_pallas.py:519", "f32"),
                                ("Q-ENC", "samnerf_tpu/ops/hash_pallas.py:1180", "int8")):
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["shape"] == "nerfacto" and r["positions"] == "uniform"
                   and r["hash_fn"] == "morton" and r["variant"] in ("f32", "q8"))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": serve[run]["launches"][name],
                        "launches_by_path": {"serve_f32": serve["f32"]["launches"][name],
                                             "serve_int8": serve["int8"]["launches"][name],
                                             "train": train["launches"][name]},
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                        "library_ms": None,
                        "ms_frame_positions": next(
                            r["ms"] for r in mine if r["shape"] == "nerfacto"
                            and r["positions"] == "frame" and r["variant"] in ("f32", "q8"))})
    for k in kernels:
        k["launches_by_path"].update(serve_int8_fused=serve["int8_fused"]["launches"][k["name"]])
    f32_enc = kernels[0]
    f32_enc["max_abs_err"] = max(f32_enc["max_abs_err"],
                                 max(r["fwd_max_abs_err"] for r in train_rows
                                     if r["kernel"] == "F32-ENC-BWD"))
    step_rep = next(r for r in train_rows if r["kernel"] == "F32-ENC-BWD"
                    and r["shape"] == "nerfacto" and r["positions"] == "step")
    f32_enc["ms_step_positions"] = step_rep["fwd_ms"]

    def pass_entry(pass_name, paths):
        """A layout pass of the f32 kernels, listed beside the kernel that
        needs it: its launches on that kernel's paths, its SAM pyramid row."""
        by_path = {p: r["pass_launches"][pass_name] for p, r in paths.items()}
        prow = next(r for r in rows + train_rows if r["kernel"] == pass_name)
        return {"name": pass_name, "source": source, "launches": max(by_path.values()),
                "launches_by_path": by_path,
                **{k: prow[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by")}}

    f32_enc["passes"] = [pass_entry("BF16-PACK", {"serve_f32": serve["f32"], "train": train})]
    # the SAM head stands for FUSED-QMLP: its largest function per launch
    rep = next(r for r in qmlp_rows if r["shape"] == "sam" and r["variant"] == "q8"
               and r["positions"] == "uniform")
    kernels.append({"name": "FUSED-QMLP", "route": "cuda", "source": source,
                    "replaces": "samnerf_tpu/ops/hash_pallas.py:1500",
                    "launches": serve["int8_fused"]["launches"]["FUSED-QMLP"],
                    "launches_by_path": {
                        "serve_int8_fused": serve["int8_fused"]["launches"]["FUSED-QMLP"],
                        "view": view["launches"]},
                    "max_abs_err": max(r["max_abs_err"] for r in qmlp_rows),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None, "unfused_route_ms": rep["unfused_route_ms"],
                    "ms_frame_positions": next(
                        r["ms"] for r in qmlp_rows if r["shape"] == "sam"
                        and r["variant"] == "q8" and r["positions"] == "frame")})
    bwd_rows = [r for r in train_rows if r["kernel"] == "F32-ENC-BWD"]
    rep = next(r for r in bwd_rows if r["shape"] == "nerfacto" and r["hash_fn"] == "morton"
               and r["positions"] == "uniform")
    kernels.append({"name": "F32-ENC-BWD", "route": "cuda", "source": source,
                    "replaces": "samnerf_tpu/ops/hash_pallas.py:644",
                    "launches": train["launches"]["F32-ENC-BWD"],
                    "launches_by_path": {"train": train["launches"]["F32-ENC-BWD"]},
                    "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None, "ms_step_positions": step_rep["ms"],
                    "passes": [pass_entry("GRAD-DEINTERLEAVE", {"train": train})]})
    rep = next(r for r in attn_rows if r["shape"] == "vit_h")
    kernels.append({"name": "FLASH-RELPOS", "route": "cuda",
                    "source": "samnerf_tpu_torch/csrc/attention_relpos.cu",
                    "replaces": "samnerf_tpu/ops/attention_pallas.py:32",
                    "launches": encode["launches"],
                    "launches_by_path": {"encode": encode["launches"],
                                         "preprocess": preprocess["launches"]},
                    "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"]})
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "nvcc": nvcc, "build_s": build_s, "kernel_resources": resources, "kernel_rows": rows,
         "qmlp_kernel_rows": qmlp_rows,
         "train_kernel_rows": train_rows, "serve": serve, "reference": reference,
         "view": view, "train": train,
         "train_reference": train_reference, "attn_kernel_rows": attn_rows,
         "encode": encode, "encode_reference": encode_reference,
         "preprocess": preprocess, "kernels": kernels}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
