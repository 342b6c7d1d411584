#!/usr/bin/env python3
"""Drive the PyTorch port (``samnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. build the CUDA kernels from ``samnerf_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once; the toolkit's release printed) and print
   ``ptxas``'s registers, spills and shared memory of the F32-ENC,
   F32-ENC-BWD, Q-ENC, FUSED-QMLP and FLASH-RELPOS kernels, f32 and bf16
   (raises on a spill);
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
   cull: ``SamNerfRenderer.bake_occupancy`` (res 96, sub 2) on the f32 and
   the baked int8 fused full-width model (ms, occupied fraction, 54
   F32-ENC or Q-ENC launches); an all-occupied grid gives the un-culled
   ``serve_frame_fn`` frame and grids bit for bit with f32, int8 and int8
   fused tables; a ball grid (radius 0.25 about the centre) installed
   through ``occupancy_from_cells``: the share of proposal and nerf
   samples culled per 512x512 frame, frame ms with and without it, and
   with ``serve_transmittance_eps`` 1e-2 too (peak memory); a small
   model's culled 64x64 frame (grid and early termination) on the card
   against the CPU;
   viewer: ``ViewerState`` at a free port over that int8 fused model with
   a seeded ``SamPredictor``, driven by a ``websockets`` client in this
   process: the scene box, a static camera (high, 512x512), three moving
   ones (low_move through the "move" renderer at the dynamic resolution),
   a static one (low_static, then high), "Output Render" masked_rgb, SAM
   and a click locked in 3D, a crop, a frame with the ball grid, and a
   camera path saved through the client's message and rendered by
   ``scripts/render.py --traj filename``; each JPEG against its
   ``render_view`` output, message -> image ms per render state;
   serve_bf16: the same model with ``compute_dtype=torch.bfloat16``:
   512x512 frames with f32 tables, baked int8, and baked int8 with
   ``serve_fuse_mlp`` (Q-ENC and the unfused bf16 MLPs: FUSED-QMLP
   computes in f32 only), ``render_view`` with one click, and a small bf16
   model's grids on the card against the CPU;
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
   eval: the train entry (``train.train_loop``) at full width on a
   synthetic 512x512 scene with 2 test images, both eval cadences firing
   and ``vis="json"`` (``metrics.json`` holds ``Eval Loss``, ``Test
   PSNR``, ``Eval Images Metrics/psnr``; F32-ENC and F32-ENC-BWD launches
   of the run against its steps, eval batches and eval images); ms per
   eval image, PSNR, SSIM, peak memory and F32-ENC launches per eval
   image against the renderer's chunking; ``scripts/eval.py``'s ``main``
   on the run directory; LPIPS on seeded VGG16 and head weights found
   through ``LPIPS_VGG_WEIGHTS`` / ``LPIPS_LIN_WEIGHTS`` (ms at 512x512,
   card against CPU); the checkpoint reloaded through
   ``TrainerConfig.load_dir`` bit for bit; a small model's eval image on
   the card against the CPU;
7. attn_kernel: FLASH-RELPOS against its plain version at SAM ViT-H's
   and ViT-B's global-attention shapes, a small ragged one and ViT-H's
   with a peaky softmax (q scaled by 8, logits to about +-30): max abs
   error, time, the 3xTF32 tensor-core bound and the f32 CUDA-core one,
   and ``scaled_dot_product_attention`` with the materialised bias as a
   yardstick; attn_bf16_kernel: the bf16 FLASH-RELPOS against its plain
   version on bf16 operands at ViT-H's, ViT-B's, the ragged shape and
   ViT-H's peaky case, within one bf16 ulp, with its bf16 bounds, plain
   and library times, each row naming the kernel ``bf16_route`` chose
   (the wgmma kernel on the 64-wide grids, the ``mma.sync`` one on the
   ragged shape); every row keeps a digest of the kernel's output bits;
8. encode: SAM ViT-H at full width (seeded weights, saved once as a
   reference-layout checkpoint and loaded through ``build_sam``) through
   ``SamPredictor.set_image`` on 512x512 frames (ms per image, peak
   memory, FLASH-RELPOS launches per image, click -> mask ms), and the
   kernel route's embedding against the plain route's; then a small
   encoder on the card against the same encoder on the CPU, in f32 and
   in bf16 (its 16-wide grid takes the ``mma.sync`` bf16 kernel);
   encode_bf16: ``build_sam_vit_h(checkpoint,
   compute_dtype=torch.bfloat16)`` through ``set_image`` (ms per image,
   peak memory, 4 bf16 FLASH-RELPOS launches per image, all by the wgmma
   kernel, the embedding's error against the f32 encode, the kernel route
   against the plain version in its place);
   amg: ``SamAutomaticMaskGenerator`` over the same ViT-H on a 512x512
   frame with the JAX package's defaults, then with the IoU and stability
   filters off and one crop layer (5 crops: ms per ``generate``, masks,
   peak memory, 4 FLASH-RELPOS launches per ``set_image``), and a small
   SAM's ``generate`` on the card against the CPU;
9. preprocess: ``python -m samnerf_tpu_torch.preprocessing
   .get_image_embeddings`` (its ``main``) with that checkpoint on a
   synthetic 24-image 512x512 scene, the port's feature loader on the
   files, and 3 ``Trainer`` steps on them;
10. clipseg_checkpoint: seeded CLIP ViT-B/16 and ``rd64-uni`` weights in
   the reference layouts and a small merges file, in the same temporary
   directory; clipseg: ``ClipSegPredictor`` at full width on the card
   (ms per ``encode_text`` of 3 prompts, ``segment``,
   ``reduced_activations``, ``decode_rendered``; peak memory) and against
   the CPU on one frame;
11. preprocess_clipseg: ``python -m samnerf_tpu_torch.preprocessing
   .get_clipseg_embeddings`` (its ``main``) on the same scene, the
   feature loader on its files, and 3 ``samnerf_distill`` steps on the
   SAM and ClipSeg targets the port wrote;
12. text_view: the view phase with a ``ClipSegPredictor`` and a text
   prompt in every view (``clipseg_feature`` in [0, 1], the heatmap's
   points reach the mask decode after the pins);
13. no_distill_view: ``render_view`` of the ``samnerf_no_distill``
   preset's model at full width with a ``LanguageSAM`` (the ViT-H
   checkpoint and the seeded ClipSeg): a click view, three moved views
   with the click locked, a text-prompt view; 4 FLASH-RELPOS launches per
   view, the locked point in every mask decode;
14. no_distill_train: 10 full-width ``samnerf_no_distill`` steps through
   ``Trainer`` on the scene; train_bf16: ``samnerf_distill
   --model.compute-dtype bfloat16`` through the train entry at full width
   on the train phase's synthetic scene (ms per step, rays/s, peak
   memory, 6 F32-ENC and 6 F32-ENC-BWD launches per step);
   viewer_train: the train entry with ``--vis viewer`` on free ports, 35
   full-width steps on that scene, a client that gets frames while it
   trains (step ms beside the train phase's; 6 + 6 launches a step and 22
   F32-ENC a 512x512 viewer frame);
15. one ``{"kernels": [...]}`` line (the f32 kernels' layout passes
   listed under ``passes`` beside the kernel that needs them; the bf16
   FLASH-RELPOS routes as ``FLASH-RELPOS-BF16-WGMMA`` and
   ``FLASH-RELPOS-BF16``), then
   ``{"ok": true, "device": ...}`` as the last line.

Float32 matmuls and convolutions run in full f32 (TF32 off) so the card
and the CPU compute the same function; bf16 GEMMs keep PyTorch's default
reduction settings.  Exits non-zero without a result
when no CUDA device is present.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
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
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
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
# the peaky case: ViT-H's shape with q scaled by this (logits to about
# +-30), where a single TF32 pass would miss TOL_ATTN
ATTN_PEAKY = ("vit_h_peaky", 16, 64, 64, 80)
ATTN_PEAKY_GAIN = 8.0
# the small model of the card-against-CPU phases
SMALL_MODEL = dict(
    num_levels=8, max_res=256, log2_hashmap_size=14,
    num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
    proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                        "num_levels": 4, "max_res": 64},),
    hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
    hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=2, hash_fn="morton")
SMALL_ENCODER = dict(img_size=256, patch_size=16, embed_dim=160, depth=4,
                     num_heads=2, mlp_ratio=4.0, out_chans=256, window_size=7,
                     global_attn_indexes=(2,), flash_min_tokens=256)
CLIPSEG_PROMPTS = ["a man is cooking", "a photo of a ball", "the wooden table"]
CLIPSEG_CALLS = 6               # per timed function; the first is the warm-up
# ClipSeg card vs CPU: text embeddings, reduced activations and logits are
# O(1); f32 sums in other orders through CLIP's 12 blocks and the decoder's
# 3 move them by ~1e-5 (the encoder's TOL_ENCODE reasoning); a wrong weight,
# token or position-grid resize moves them by 1e-2 or more
TOL_CLIPSEG = dict(rtol=1e-3, atol=1e-3)
NO_DISTILL_TRAIN_STEPS = 10
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 on the tensor cores
# the bf16 FLASH-RELPOS against its plain version (both f32 inside, the
# output rounded once): one bf16 ulp, |d| <= 2^-7 |ref| + 1e-5 max |ref|;
# the absolute term covers outputs near 0, where the two f32 values (the
# kernel's tensor-core sums and hi/lo P against cuBLAS f32) differ by up
# to ~2e-6 max |ref| (the f32 kernel's own level) before they are rounded
BF16_ULP = 2.0 ** -7
BF16_ULP_ABS = 1e-5
BF16_TRAIN_WARMUP, BF16_TRAIN_STEPS = 3, 10
BF16_FRAMES = 3                 # timed frames per bf16 serve run, after a warm-up


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


# the kernels (by source) whose ptxas report is printed and held to no spills
RESOURCE_KERNELS = {"hash_encode": ("f32_encode_kernel", "f32_encode_bwd_kernel",
                                    "q_encode_kernel", "qmlp_kernel"),
                    "attention_relpos": ("flash_relpos_kernel", "flash_relpos_bf16_kernel",
                                         "flash_relpos_bf16_wgmma_kernel")}


def kernel_resources():
    """``ptxas``'s registers, spills and shared memory of F32-ENC,
    F32-ENC-BWD, Q-ENC, FUSED-QMLP and FLASH-RELPOS (f32 and both bf16), named
    by their template arguments; raises if one of them spills."""
    import re

    from samnerf_tpu_torch.ops import cuda_build

    rows = []
    for source, names in RESOURCE_KERNELS.items():
        for r in cuda_build.kernel_resources(source):
            m = re.search(r"(%s)I((?:L[ib]\d+E)+)E" % "|".join(names), r["kernel"])
            if m:
                args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
                rows.append(dict(r, name=f"{m.group(1)}<{args}>"))
    for r in rows:
        print(f"ptxas {r['name']:34s} {r['registers']:3d} registers, spill stores "
              f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, stack "
              f"{r['stack']} B, static smem {r['static_smem']} B", flush=True)
    missing = [k for names in RESOURCE_KERNELS.values() for k in names
               if not any(r["name"].startswith(k + "<") for r in rows)]
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

    cfg = SAMModelConfig(**SMALL_MODEL)
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


def view_phase(dev, cfg=None, size=VIEW_SIZE, chunk=1 << 15, clipseg=None):
    """``render_view`` with baked int8 tables through FUSED-QMLP (full
    ``samnerf_distill`` width unless ``cfg`` is given): a click in view 0
    is locked in 3D, three further cameras re-project it, then one view
    with a crop box.  Raises if a locked pin that lies in bounds and in
    front of the depth is not drawn.  With ``clipseg`` (the paths of
    :func:`clipseg_checkpoint`) a ``ClipSegPredictor`` joins the renderer
    and every view carries a text prompt: raises unless
    ``clipseg_feature`` is [512, 512, 1] in [0, 1] and the mask decode
    got the in-bounds pins followed by the heatmap's points."""
    from samnerf_tpu_torch.engine.render_pipeline import (SamNerfRenderer,
                                                          cameras_from_intrin_c2w, project,
                                                          pooled_heatmap_points, visible_mask)
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
    text = None if clipseg is None else CLIPSEG_PROMPTS[1]
    snr = SamNerfRenderer(model, sam_predictor=SamPredictor(sam), chunk=chunk,
                          serve_preset="static", clipseg_predictor=None if clipseg is None
                          else _clipseg_predictor(clipseg, dev))
    snr.bake_serve_tables()
    decoded = _record_points(snr.predictor)
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
        decoded.clear()
        t0 = time.perf_counter()
        out = snr.render_view(cams, 0, intrin, c2w, points=points, text_prompt=text, **crop)
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
        if text is not None:
            heat = out.get("clipseg_feature")
            if heat is None or heat.shape != (VIEW_SIZE, VIEW_SIZE, 1) or not (
                    np.isfinite(heat).all() and heat.min() >= 0.0 and heat.max() <= 1.0):
                raise AssertionError(f"view {i}: clipseg_feature "
                                     f"{None if heat is None else heat.shape} or not in [0, 1]")
            text_pts = pooled_heatmap_points(heat[..., 0], (size, size))
            want = np.concatenate([pins[legal].astype(np.float64)]
                                  + ([] if text_pts is None else [text_pts]))
            n_text = 0 if text_pts is None else len(text_pts)
            if len(decoded) != 1 or not np.array_equal(decoded[0], want):
                raise AssertionError(f"view {i}: the mask decode got {len(decoded)} prompts, "
                                     f"not the {int(legal.sum())} pins and {n_text} text points")
            row.update(text_points=n_text, heat_mean=float(heat.mean()))
        rows.append(row)
        print(f"{'text_' if text else ''}view {i}{' crop' if row['crop'] else ''} "
              f"{size}x{size}: {ms:.1f} ms, "
              f"{row['locked']} locked, pins {row['pins']} in bounds {row['in_bounds']} "
              f"visible {row['visible']} drawn {drawn}, mask covers "
              f"{100 * row['mask_fraction']:.1f} % of the frame"
              + (f", {row['text_points']} text points" if text else "") + "; launches "
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
    if text is not None and not all(r["text_points"] for r in rows[:4]):
        raise AssertionError(f"a view's heatmap gave no text point: {rows[:4]}")
    timed = [r["ms"] for r in rows[1:4]]
    result = dict(views=rows, view_ms=statistics.median(timed), view_ms_all=timed,
                  click_view_ms=rows[0]["ms"], crop_view_ms=rows[4]["ms"],
                  launches_per_view=FUSED_PER_FRAME, text_prompt=text,
                  launches=sum(r["launches"]["FUSED-QMLP"] for r in rows))
    print(f"{'text_' if text else ''}view: median {result['view_ms']:.1f} ms per moved view "
          f"({', '.join(f'{t:.1f}' for t in timed)}), click view {rows[0]['ms']:.1f} ms, "
          f"crop view {rows[4]['ms']:.1f} ms; FUSED-QMLP {FUSED_PER_FRAME} launches per "
          f"view", flush=True)
    del snr, model, sam
    return result


def _record_points(predictor):
    """Wrap ``predictor.predict`` to keep the point prompts of each call
    (the list it returns)."""
    calls, predict = [], predictor.predict

    def wrapped(**kw):
        calls.append(np.asarray(kw["point_coords"]))
        return predict(**kw)

    predictor.predict = wrapped
    return calls


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

    cfg = SAMModelConfig(**SMALL_MODEL)
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


def train_bf16_phase(dev, root: Path):
    """``samnerf_distill`` with ``--model.compute-dtype bfloat16`` through
    the port's train entry (``train.parse``, ``train.train_loop``) at full
    width on the train phase's synthetic scene: ms per step over
    ``BF16_TRAIN_STEPS`` after ``BF16_TRAIN_WARMUP``, rays/s, peak memory,
    finite losses, and 6 F32-ENC and 6 F32-ENC-BWD launches per step (the
    hash encodes stay f32; their cotangents arrive in f32)."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.utils.synthetic import write_scene

    scene = write_scene(root / "scene_bf16", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    config = train_entry.parse([
        "samnerf_distill", "--data", str(scene), "--model.compute-dtype", "bfloat16",
        "--vis", "none",
        "--trainer.max-num-iterations", str(BF16_TRAIN_WARMUP + BF16_TRAIN_STEPS),
        "--trainer.save-final", "false", "--trainer.output-dir", str(root / "out_bf16")])
    if config.model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"the CLI gave compute_dtype {config.model.compute_dtype}")
    losses, times, t_prev = [], [], [0.0]

    def on_step(step, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step == BF16_TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
            _reset_encode_launches(hg)
        elif step > BF16_TRAIN_WARMUP:
            times.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now

    trainer = train_entry.train_loop(config, device=dev, step_callback=on_step)
    if trainer.model.fields.mlp_base.compute_dtype != torch.bfloat16:
        raise AssertionError("the trained model is not bf16")
    launches = {"F32-ENC": hg.parity_hash_encode.launches,
                "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                "Q-ENC": hg.parity_hash_encode_q8.launches}
    peak = torch.cuda.max_memory_allocated()
    rays = trainer.datamanager.config.train_num_rays_per_batch
    del trainer
    step_ms = statistics.median(times)
    result = dict(step_ms=step_ms, step_ms_all=times, rays_per_s=rays / step_ms * 1e3,
                  steps=len(times), launches=launches,
                  launches_per_step={k: v / len(times) for k, v in launches.items()},
                  max_memory_allocated=peak, first_losses=losses[0], last_losses=losses[-1])
    print(f"train_bf16 samnerf_distill --model.compute-dtype bfloat16, {rays} rays/step: "
          f"median step {step_ms:.2f} ms over {len(times)} steps ({min(times):.1f}-"
          f"{max(times):.1f}), {result['rays_per_s']:,.0f} rays/s; launches/step "
          + ", ".join(f"{k}={v:g}" for k, v in result["launches_per_step"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB; losses first {losses[0]} "
          f"last {losses[-1]}", flush=True)
    if len(losses) != BF16_TRAIN_WARMUP + BF16_TRAIN_STEPS or not all(
            math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"bf16 train losses: {losses}")
    if launches["F32-ENC"] != F32_PER_STEP * len(times) \
            or launches["F32-ENC-BWD"] != F32_PER_STEP * len(times) or launches["Q-ENC"]:
        raise AssertionError(f"the bf16 train path launched {launches} in {len(times)} "
                             f"steps, not {F32_PER_STEP} + {F32_PER_STEP} per step")
    return result


# bf16 serve runs (tag, hash_q8_serve, serve_fuse_mlp) and the encodes
# each must launch: FUSED-QMLP computes in f32 only, so a bf16 model with
# serve_fuse_mlp serves through Q-ENC and its bf16 MLPs, as JAX does
BF16_SERVE_RUNS = (("f32_tables", False, False, {"F32-ENC"}),
                   ("int8", True, False, {"Q-ENC"}),
                   ("int8_fuse_mlp", True, True, {"Q-ENC"}))


def serve_bf16_phase(dev, cfg=None, size=VIEW_SIZE):
    """A ``compute_dtype=bfloat16`` model at full ``samnerf_distill`` width
    unless ``cfg`` is given (seed 0): 512x512 ``serve_frame_fn`` frames with f32 tables, baked
    int8, and baked int8 with ``serve_fuse_mlp`` (Q-ENC, no FUSED-QMLP),
    ms per frame and peak memory; ``render_view`` with one click; then a
    small bf16 model's 64x64 grids on the card against the CPU.  The card
    and the CPU round the same bf16 products after sums taken in other
    orders (cuBLAS may also reduce bf16 GEMMs in reduced precision), so
    the pair is held at a mean absolute difference of at most half the
    card's own bf16-against-f32 one, per grid."""
    from samnerf_tpu_torch.engine.render_pipeline import (SamNerfRenderer,
                                                          cameras_from_intrin_c2w)
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.utils.init import init_state
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w

    H = W = size
    cfg = dataclasses.replace(cfg or SAMModelConfig(hash_fn="morton"),
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    clicks = [(x * size / VIEW_SIZE, y * size / VIEW_SIZE)
              for x, y in ((256.0, 256.0), (100.0, 300.0), (400.0, 120.0), (320.0, 420.0))]
    focal = 400.0 * size / VIEW_SIZE
    results = {}
    for tag, q8, fuse, kernels in BF16_SERVE_RUNS:
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, sam_predictor=SamPredictor(sam) if fuse else None,
                              serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        serve = snr.serve_frame_fn(sam, H, W)
        serve(_cameras(dev, 0, H, W, focal), 0, clicks[0])        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_encode_launches(hg)
        times = []
        for i, click in enumerate(clicks[1:BF16_FRAMES + 1], start=1):
            t0 = time.perf_counter()
            img = serve(_cameras(dev, i, H, W, focal), 0, click)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
                raise AssertionError(f"bf16 frame {img.dtype} {tuple(img.shape)}")
        launches = _encode_launches(hg)
        results[tag] = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                            launches=launches,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"serve_bf16 {tag:13s} 512x512 static: median frame "
              f"{results[tag]['frame_ms']:.2f} ms over {len(times)} frames "
              f"({', '.join(f'{t:.1f}' for t in times)}); launches/frame "
              + " ".join(f"{k}={v / len(times):g}" for k, v in launches.items())
              + f"; max_memory_allocated="
              f"{results[tag]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        ran = {k for k, v in launches.items() if v}
        if ran != kernels:
            raise AssertionError(f"the bf16 {tag} serve path launched {launches}")
        del serve
        if fuse:
            intrin = VIEW_INTRIN * (size / VIEW_SIZE)
            intrin[2, 2] = 1.0
            c2w = look_at_c2w(np.array([1.2 * np.cos(0.3), 1.2 * np.sin(0.3), 0.45]),
                              np.zeros(3))
            cams = cameras_from_intrin_c2w(intrin, c2w, H, W, device=dev)
            _reset_encode_launches(hg)
            t0 = time.perf_counter()
            out = snr.render_view(cams, 0, intrin, c2w,
                                  points=np.array([[0.45 * size, 0.55 * size]]))
            view_ms = (time.perf_counter() - t0) * 1e3
            for k in ("rgb", "depth", "masked_rgb"):
                if out[k].shape[:2] != (H, W) or not np.isfinite(out[k]).all():
                    raise AssertionError(f"bf16 view {k}: {out[k].shape} or not finite")
            results["view"] = dict(ms=view_ms, launches=_encode_launches(hg),
                                   locked=len(snr.prompts))
            print(f"serve_bf16 render_view {H}x{W} one click: {view_ms:.1f} ms, "
                  f"{len(snr.prompts)} locked; launches {results['view']['launches']}",
                  flush=True)
            if not results["view"]["launches"]["Q-ENC"] \
                    or results["view"]["launches"]["FUSED-QMLP"]:
                raise AssertionError(f"the bf16 view launched {results['view']['launches']}")
        del model, snr

    small = SAMModelConfig(
        num_levels=8, max_res=256, log2_hashmap_size=14,
        num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
        proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                            "num_levels": 4, "max_res": 64},),
        hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
        hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=2, hash_fn="morton")
    grids = {}
    for tag, d, dt in (("card_bf16", dev, torch.bfloat16), ("cpu_bf16", "cpu", torch.bfloat16),
                       ("card_f32", dev, torch.float32)):
        c = dataclasses.replace(small, compute_dtype=dt)
        model = SAMModel(c, device=d)
        model.load_state_dict(init_state(SAMModel(c, device="meta"),
                                         torch.Generator().manual_seed(1), device=d,
                                         table_scale=0.5))
        snr = SamNerfRenderer(model, chunk=1024, serve_preset="static")
        out = snr.renderer.render_image_device(_cameras(d, 1, 64, 64, 50.0), 0, 64, 64,
                                               ("sam", "clipseg"), minimal=True)
        grids[tag] = {k: out[k].float().cpu() for k in ("rgb", "sam", "clipseg")}
    reference = {}
    for k in ("rgb", "sam", "clipseg"):
        diff = (grids["card_bf16"][k] - grids["cpu_bf16"][k]).abs()
        bf16_diff = (grids["card_bf16"][k] - grids["card_f32"][k]).abs()
        reference[k] = dict(mean_abs_diff=diff.mean().item(), max_abs_diff=diff.max().item(),
                            bf16_vs_f32_mean=bf16_diff.mean().item())
    results["reference"] = reference
    print("serve_bf16 reference: small bf16 model 64x64 card vs CPU "
          + "; ".join(f"{k} mean {r['mean_abs_diff']:.3e} max {r['max_abs_diff']:.3e} "
                      f"(bf16 vs f32 mean {r['bf16_vs_f32_mean']:.3e})"
                      for k, r in reference.items()), flush=True)
    for k, r in reference.items():
        if not (r["mean_abs_diff"] <= 0.5 * r["bf16_vs_f32_mean"]
                and r["bf16_vs_f32_mean"] > 0):
            raise AssertionError(f"bf16 card and CPU {k} grids disagree: {r}")
    return results


def attn_inputs(dev, gen, b, gh, gw, d, q_gain=1.0):
    """q, k, v ~ N(0, 1), as a seeded layer's LayerNorm and lecun-normal
    qkv give them (q times ``q_gain``); rel-pos tables N(0, 0.02)
    (``init_state``) contracted with q by the encoder's own
    ``decomposed_rel_terms`` -> (q, k, v, rel_h, rel_w, scale)."""
    from samnerf_tpu_torch.perception.sam.image_encoder import decomposed_rel_terms

    n = gh * gw
    q, k, v = (torch.randn((b, n, d), generator=gen, device=dev) for _ in range(3))
    q *= q_gain
    tables = [torch.randn((2 * s - 1, d), generator=gen, device=dev) * 0.02
              for s in (gh, gw)]
    rel_h, rel_w = decomposed_rel_terms(q, *tables, (gh, gw), (gh, gw))
    return (q, k, v, rel_h.reshape(b, n, gh).contiguous(),
            rel_w.reshape(b, n, gw).contiguous(), d ** -0.5)


def attn_bound(b, n, d, gh, gw) -> dict:
    """FLASH-RELPOS's least time.  Operations: q.k and p.v, a multiply-add
    per (query, key, dim) each, three TF32 passes apiece at f32 precision
    (3xTF32) on the tensor cores; bytes: q, k, v, rel_h, rel_w read once,
    the output written.  ``f32_core_bound_ms`` is the same work at the f32
    rate outside the tensor cores (the first design's yardstick)."""
    flops = 4 * b * n * n * d
    nbytes = 4 * (4 * b * n * d + b * n * (gh + gw))
    t_ops, t_bytes = 3 * flops / TF32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                f32_core_bound_ms=max(flops / F32_OPS_PER_S, t_bytes) * 1e3,
                gflop=flops / 1e9)


def _digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes, so two
    checkouts' kernels can be held bit for bit across processes."""
    data = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def attn_kernel_phase(dev, reps: int = 20, ref_reps: int = 5):
    """FLASH-RELPOS against its plain version at ``ATTN_SHAPES`` and the
    peaky case, timed (``reps`` calls; ``ref_reps`` of the plain version
    and of the library call) beside the plain version and one library
    call."""
    import torch.nn.functional as F

    from samnerf_tpu_torch.ops import attention as ta

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    cases = [(*shape, 1.0) for shape in ATTN_SHAPES] + [(*ATTN_PEAKY, ATTN_PEAKY_GAIN)]
    for name, b, gh, gw, d, q_gain in cases:
        n = gh * gw
        q, k, v, rel_h, rel_w, scale = attn_inputs(dev, gen, b, gh, gw, d, q_gain)
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
        logit_absmax = (torch.matmul(q[:1] * scale, k[:1].transpose(-2, -1))
                        .abs().max().item())
        digest = _digest(out)
        del out, ref
        ms = _time_ms(run, reps=reps)
        plain_ms = _time_ms(plain, reps=ref_reps)
        library_ms = _time_ms(library, reps=ref_reps)
        del bias
        row = dict(kernel="FLASH-RELPOS", shape=name, heads=b, tokens=n, head_dim=d,
                   grid=(gh, gw), q_gain=q_gain, logit_absmax_head0=logit_absmax,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_max_abs_err=library_err, out_digest=digest,
                   **attn_bound(b, n, d, gh, gw))
        row["tflops"] = row["gflop"] / ms
        rows.append(row)
        print(f"attn kernel FLASH-RELPOS {name:11s} B={b:2d} N={n:5d} D={d:2d} "
              f"err={err:.3e} (tol {TOL_ATTN:g}, |logit| max {logit_absmax:.1f}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
              f"(err {library_err:.1e}) bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}, 3xTF32) f32_core_bound_ms="
              f"{row['f32_core_bound_ms']:.4f}, {row['tflops']:.1f} TFLOP/s", flush=True)
        del q, k, v, rel_h, rel_w
    return rows


def attn_bf16_bound(b, n, d, gh, gw) -> dict:
    """The bf16 FLASH-RELPOS's least time: bytes (bf16 q, k, v, rel_h,
    rel_w read once, the output written) at 3.35 TB/s against q.k and p.v,
    a multiply-add per (query, key, dim) each, at the dense bf16 rate;
    ``design_bound_ms`` counts this design's MMAs (p.v twice, P as a hi
    and a lo bf16 part)."""
    flops = 4 * b * n * n * d
    nbytes = 2 * (4 * b * n * d + b * n * (gh + gw))
    t_ops, t_bytes = flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                design_bound_ms=max(1.5 * t_ops, t_bytes) * 1e3, gflop=flops / 1e9,
                mbytes=nbytes / 1e6)


def bf16_ulp_excess(out, ref) -> tuple:
    """(largest |out - ref| - (2^-7 |ref| + 1e-5 max|ref|), the share of
    elements over it); ``out`` within one bf16 ulp of ``ref`` where the
    first is <= 0."""
    out, ref = out.float(), ref.float()
    excess = (out - ref).abs() - (BF16_ULP * ref.abs() + BF16_ULP_ABS * ref.abs().max())
    return excess.max().item(), (excess > 0).float().mean().item()


def attn_bf16_kernel_phase(dev, reps: int = 20, ref_reps: int = 5):
    """The bf16 FLASH-RELPOS against its plain version on the same bf16
    operands at ``ATTN_SHAPES`` and the peaky case, within one bf16 ulp;
    each row names the kernel that ran (``bf16_route``: the wgmma kernel
    on the 64-wide grids, ``mma.sync`` on the ragged shape), timed beside
    the plain version and ``scaled_dot_product_attention`` in bf16 with
    the bias materialised.  A checkout from before the wgmma kernel (timed
    by ``scripts/bench_attention.py --root``) has only the ``mma.sync``
    route."""
    import torch.nn.functional as F

    from samnerf_tpu_torch.ops import attention as ta

    fn = ta.flash_attention_relpos
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    cases = [(*shape, 1.0) for shape in ATTN_SHAPES] + [(*ATTN_PEAKY, ATTN_PEAKY_GAIN)]
    for name, b, gh, gw, d, q_gain in cases:
        n = gh * gw
        *ops, scale = attn_inputs(dev, gen, b, gh, gw, d, q_gain)
        q, k, v, rel_h, rel_w = (t.bfloat16() for t in ops)
        del ops
        aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
        route = ta.bf16_route(d, gw, aligned) if hasattr(ta, "bf16_route") else "mma_sync"
        kernel = "FLASH-RELPOS-BF16-WGMMA" if route == "wgmma" else "FLASH-RELPOS-BF16"
        before = (fn.launches_bf16, getattr(fn, "launches_bf16_wgmma", 0))
        run = lambda: fn(q, k, v, rel_h, rel_w, scale)
        plain = lambda: ta.reference_attention_relpos(q, k, v, rel_h, rel_w, scale)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        after = (fn.launches_bf16, getattr(fn, "launches_bf16_wgmma", 0))
        if after != (before[0] + 1, before[1] + (route == "wgmma")) \
                or out.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 FLASH-RELPOS {name}: not the {route} kernel "
                                 f"(launches {before} -> {after})")
        err = (out.float() - ref.float()).abs().max().item()
        excess, share = bf16_ulp_excess(out, ref)
        if not math.isfinite(err) or excess > 0:
            raise AssertionError(f"{kernel} {name}: {share:.2e} of the outputs "
                                 f"beyond one bf16 ulp (by up to {excess:.2e})")
        bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, n, n)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
        library_err = (library().float() - ref.float()).abs().max().item()
        digest = _digest(out)
        del out, ref
        ms = _time_ms(run, reps=reps)
        plain_ms = _time_ms(plain, reps=ref_reps)
        library_ms = _time_ms(library, reps=ref_reps)
        del bias
        row = dict(kernel=kernel, route=route, shape=name, heads=b, tokens=n, head_dim=d,
                   grid=(gh, gw), q_gain=q_gain, max_abs_err=err, ulp_excess=excess, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=library_err,
                   out_digest=digest, **attn_bf16_bound(b, n, d, gh, gw))
        row["tflops"] = row["gflop"] / ms
        rows.append(row)
        print(f"attn kernel {kernel} {name:11s} B={b:2d} N={n:5d} D={d:2d} "
              f"err={err:.3e} (within one bf16 ulp) ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={library_ms:.3f} (err {library_err:.1e}) bound_ms="
              f"{row['bound_ms']:.4f} ({row['bound_by']}, bf16) design_bound_ms="
              f"{row['design_bound_ms']:.4f}, {row['tflops']:.1f} TFLOP/s", flush=True)
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
    version: in f32 at ``TOL_ENCODE``, and with ``compute_dtype=bfloat16``,
    whose global layer (a 16-wide grid) takes the ``mma.sync`` bf16 kernel.
    The bf16 pair is held at a mean absolute difference no larger than the
    card's own bf16 output's mean distance from its f32 one, as
    ``encode_bf16_phase`` holds its two routes: one-ulp flips of bf16
    products summed in other orders spread through the blocks, and a wrong
    kernel would put the two further apart than bf16 is from f32."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
    from samnerf_tpu_torch.utils.init import init_state

    fn = ta.flash_attention_relpos
    x = np.random.default_rng(9).normal(size=(1, 256, 256, 3)).astype(np.float32)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        for d in (dev, "cpu"):
            enc = ImageEncoderViT(**SMALL_ENCODER, compute_dtype=dt, device=d)
            enc.load_state_dict(init_state(ImageEncoderViT(**SMALL_ENCODER, device="meta"),
                                           torch.Generator().manual_seed(5), device=d))
            before = (fn.launches, fn.launches_bf16, fn.launches_bf16_wgmma)
            with torch.no_grad():
                outs[(dt, str(d))] = enc(torch.as_tensor(x, device=d)).float().cpu()
            launches = tuple(a - b for a, b in zip(
                (fn.launches, fn.launches_bf16, fn.launches_bf16_wgmma), before))
            want = (0, 0, 0) if d == "cpu" else (1, 0, 0) if dt == torch.float32 else (0, 1, 0)
            if launches != want:
                raise AssertionError(f"small {dt} encoder on {d}: FLASH-RELPOS launches "
                                     f"(f32, bf16, bf16 wgmma) {launches}, not {want}")
    card, cpu = str(dev), "cpu"
    err = (outs[(torch.float32, card)] - outs[(torch.float32, cpu)]).abs().max().item()
    bf16_diff = (outs[(torch.bfloat16, card)] - outs[(torch.bfloat16, cpu)]).abs().mean().item()
    bf16_vs_f32 = (outs[(torch.bfloat16, card)] - outs[(torch.float32, card)]).abs().mean().item()
    print(f"encode reference: small encoder card vs CPU max abs err {err:.3e} "
          f"(tol {TOL_ENCODE:g}); bf16 card vs CPU mean abs {bf16_diff:.3e} (bf16 vs f32 "
          f"mean {bf16_vs_f32:.3e}), 1 launch of the mma.sync bf16 kernel", flush=True)
    if not math.isfinite(err) or err > TOL_ENCODE:
        raise AssertionError(f"card and CPU encoders disagree: {err}")
    if not (bf16_diff <= bf16_vs_f32 and bf16_vs_f32 > 0):
        raise AssertionError(f"bf16 card and CPU encoders disagree: {bf16_diff} "
                             f"(bf16 vs f32 {bf16_vs_f32})")
    return dict(max_abs_err=err, bf16_mean_abs_diff=bf16_diff, bf16_vs_f32_mean=bf16_vs_f32,
                bf16_launches=1)


def encode_bf16_phase(dev, checkpoint: Path, images):
    """ViT-H with ``compute_dtype=torch.bfloat16`` from the same seeded
    checkpoint through ``SamPredictor.set_image``: ms per image after a
    warm-up, peak memory, 4 bf16 FLASH-RELPOS launches per image, all by
    the wgmma kernel, and no f32 one; the bf16 embedding's relative error against the f32 encode of
    the same frame (information); and the kernel route against the same
    bf16 encoder with the kernel's plain version in its place.  That last
    pair is held at a mean absolute difference no larger than the bf16
    embedding's mean distance from the f32 one: one-ulp flips of bf16
    products spread through 32 blocks, so the two bf16 routes differ by
    bf16 noise, and a wrong kernel would put them further apart than bf16
    is from f32."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam_vit_h
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    frame = images[ENCODE_IMAGES - 1]
    f32_predictor = SamPredictor(build_sam_vit_h(str(checkpoint), device=dev))
    f32_predictor.set_image(frame)
    f32_emb = f32_predictor.get_image_embedding().clone()
    del f32_predictor
    sam = build_sam_vit_h(str(checkpoint), device=dev, compute_dtype=torch.bfloat16)
    predictor = SamPredictor(sam)
    predictor.set_image(images[0])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn = ta.flash_attention_relpos
    fn.launches = fn.launches_bf16 = fn.launches_bf16_wgmma = 0
    times = []
    for img in images[1:ENCODE_IMAGES]:
        t0 = time.perf_counter()
        predictor.set_image(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        emb = predictor.get_image_embedding()
        if tuple(emb.shape) != (1, 64, 64, 256) or emb.dtype != torch.float32 \
                or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"bf16 embedding {tuple(emb.shape)} {emb.dtype} or not finite")
    launches, wgmma_launches, f32_launches = (fn.launches_bf16, fn.launches_bf16_wgmma,
                                              fn.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != 4 * len(times) or wgmma_launches != launches or f32_launches:
        raise AssertionError(f"bf16 ViT-H: {launches} bf16 ({wgmma_launches} by the wgmma "
                             f"kernel) and {f32_launches} f32 FLASH-RELPOS launches for "
                             f"{len(times)} images")
    kernel_emb = predictor.get_image_embedding().clone()       # of ``frame``
    rel_err = ((kernel_emb - f32_emb).norm() / f32_emb.norm()).item()
    bf16_dist = (kernel_emb - f32_emb).abs().mean().item()
    with torch.no_grad(), _plain_attention(ta):
        predictor.set_image(frame)
    plain_emb = predictor.get_image_embedding()
    if ta.flash_attention_relpos.launches_bf16 != launches:
        raise AssertionError("the plain route launched FLASH-RELPOS")
    route = (kernel_emb - plain_emb).abs()
    result = dict(image_ms=statistics.median(times), image_ms_all=times, images=len(times),
                  launches=launches, launches_wgmma=wgmma_launches,
                  launches_per_image=launches / len(times),
                  max_memory_allocated=peak, rel_err_vs_f32=rel_err,
                  mean_abs_dist_vs_f32=bf16_dist, route_mean_abs_diff=route.mean().item(),
                  route_max_abs_diff=route.max().item())
    print(f"encode_bf16 vit_h 512x512: median {result['image_ms']:.2f} ms/image over "
          f"{len(times)} images ({', '.join(f'{t:.1f}' for t in times)}); bf16 FLASH-RELPOS "
          f"launches/image {launches / len(times):g} (wgmma kernel {wgmma_launches} of "
          f"{launches}); max_memory_allocated="
          f"{peak / 2**30:.2f} GiB; embedding vs f32 relative error {rel_err:.3e} (mean abs "
          f"{bf16_dist:.3e}); kernel vs plain route mean abs {route.mean().item():.3e}, "
          f"max {route.max().item():.3e}", flush=True)
    if not route.mean().item() <= bf16_dist:
        raise AssertionError(f"bf16 kernel and plain routes disagree: {result}")
    del sam, predictor
    return result


@contextlib.contextmanager
def _plain_attention(ta):
    """Within the block, ``ops.attention.flash_attention_relpos`` (which the
    encoder reaches through ``attention_relpos``) is its plain version."""
    real = ta.flash_attention_relpos
    ta.flash_attention_relpos = ta.reference_attention_relpos
    try:
        yield
    finally:
        ta.flash_attention_relpos = real


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


def write_merges(path: Path, texts) -> None:
    """A gzip merges file in CLIP's format (a header line, one merge per
    line) whose merges build each word of ``texts`` left to right, so the
    tokenizer's byte-pair merges run without CLIP's published vocabulary."""
    import gzip

    from samnerf_tpu_torch.perception.clipseg.tokenizer import bytes_to_unicode

    enc = bytes_to_unicode()
    merges = []
    for word in " ".join(texts).lower().split():
        sym = ["".join(enc[b] for b in ch.encode("utf-8")) for ch in word]
        sym[-1] += "</w>"
        acc = sym[0]
        for s in sym[1:]:
            if (acc, s) not in merges:
                merges.append((acc, s))
            acc += s
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def clipseg_checkpoint(dev, root: Path):
    """Seeded CLIP ViT-B/16 and ``rd64-uni`` weights (``init_state``, drawn
    on the card) saved once in the reference layouts (OpenAI's keys, the
    visual tower's under ``visual.``, with ``logit_scale``; the decoder
    keys of ``rd64-uni.pth``), and a merges file for the prompts -> the
    three paths.  The decoder's output bias is raised by 2: the random
    field renders an almost uniform ClipSeg grid, which the drawn decoder
    turns into a heatmap near 0.33 everywhere, below ``render_view``'s
    0.7, so no text point would reach the mask decode; raised, every cell
    passes (and the 1000 highest are the points)."""
    from samnerf_tpu_torch.perception.clipseg.clip_model import CLIPText, CLIPVisual
    from samnerf_tpu_torch.perception.clipseg.clipseg import CLIPDensePredT
    from samnerf_tpu_torch.utils.init import init_state

    gen = torch.Generator(device=dev).manual_seed(7)
    visual = init_state(CLIPVisual(device="meta"), gen, device="cpu")
    clip = {**{f"visual.{k}": v for k, v in visual.items()},
            **init_state(CLIPText(device="meta"), gen, device="cpu"),
            "logit_scale": torch.tensor(4.6052)}
    decoder = init_state(CLIPDensePredT(device="meta"), gen, device="cpu")
    decoder["trans_conv.bias"] += 2.0
    paths = (root / "ViT-B-16_seeded.pt", root / "rd64-uni_seeded.pth",
             root / "bpe_prompts.txt.gz")
    torch.save(clip, paths[0])
    torch.save(decoder, paths[1])
    write_merges(paths[2], CLIPSEG_PROMPTS)
    print(f"clipseg checkpoints: CLIP {sum(t.numel() for t in clip.values()) / 1e6:.1f} M "
          f"parameters ({paths[0].stat().st_size / 2**20:.0f} MiB), decoder "
          f"{sum(t.numel() for t in decoder.values()) / 1e6:.2f} M", flush=True)
    return paths


def _clipseg_predictor(paths, dev):
    """A ``ClipSegPredictor`` on ``dev`` over :func:`clipseg_checkpoint`'s
    files."""
    from samnerf_tpu_torch.perception.clipseg.pipeline import ClipSegPredictor

    clip, decoder, bpe = map(str, paths)
    return ClipSegPredictor(clipseg_checkpoint=decoder, clip_checkpoint=clip, bpe_path=bpe,
                            device=dev)


def clipseg_phase(dev, paths, frames):
    """ClipSeg at full width on the card: ``encode_text`` of the 3 prompts,
    ``segment`` and ``reduced_activations`` of distinct 512x512 frames,
    ``decode_rendered`` of a 32x32x192 N(0, 1) grid (median ms over
    ``CLIPSEG_CALLS`` - 1 synchronised calls after a warm-up, peak memory);
    then the card against the same checkpoints on the CPU, one frame."""
    pred = _clipseg_predictor(paths, dev)
    grid = torch.randn((32, 32, 192), generator=torch.Generator().manual_seed(8)).numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = {}, {}
    cond = pred.encode_text(CLIPSEG_PROMPTS)
    calls = {"encode_text": lambda i: pred.encode_text(CLIPSEG_PROMPTS),
             "segment": lambda i: pred.segment(frames[i % len(frames)], cond[:1]),
             "reduced_activations": lambda i: pred.reduced_activations(frames[i % len(frames)]),
             "decode_rendered": lambda i: pred.decode_rendered(grid, cond[:1])}
    for name, fn in calls.items():
        times[name] = []
        for i in range(CLIPSEG_CALLS):
            t0 = time.perf_counter()
            outs[name] = fn(i)
            torch.cuda.synchronize()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    shapes = {"encode_text": [(3, 512)], "segment": [(512, 512)],
              "reduced_activations": [(1025, 1, 64)] * 3, "decode_rendered": [(512, 512)]}
    for name, want in shapes.items():
        got = outs[name] if isinstance(outs[name], list) else [outs[name]]
        if [tuple(t.shape) for t in got] != want or not all(
                np.isfinite(np.asarray(t.cpu() if torch.is_tensor(t) else t)).all()
                for t in got):
            raise AssertionError(f"clipseg {name}: {[tuple(t.shape) for t in got]} or not finite")
    cpu = _clipseg_predictor(paths, "cpu")
    cpu_cond = cpu.encode_text(CLIPSEG_PROMPTS)
    pairs = {"encode_text": (cond.cpu(), cpu_cond),
             "segment": (pred.segment(frames[0], cond[:1]).cpu(),
                         cpu.segment(frames[0], cpu_cond[:1])),
             "decode_rendered": (pred.decode_rendered(grid, cond[:1]).cpu(),
                                 cpu.decode_rendered(grid, cpu_cond[:1]))}
    for i, (a, b) in enumerate(zip(pred.reduced_activations(frames[0]),
                                   cpu.reduced_activations(frames[0]))):
        pairs[f"reduced_activations_{i}"] = (torch.from_numpy(a), torch.from_numpy(b))
    errs = {k: (a - b).abs().max().item() for k, (a, b) in pairs.items()}
    ratios = {k: _tol_ratio(a, b, **TOL_CLIPSEG) for k, (a, b) in pairs.items()}
    absmax = {k: b.abs().max().item() for k, (_, b) in pairs.items()}
    result = dict(ms={k: statistics.median(v) for k, v in times.items()}, ms_all=times,
                  max_memory_allocated=peak, card_vs_cpu_max_abs_err=errs,
                  card_vs_cpu_tol_ratio=ratios, cpu_absmax=absmax,
                  logits_mean=float(outs["segment"].mean()))
    print("clipseg ViT-B/16 + rd64-uni 512x512: median ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in result["ms"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB; card vs CPU max abs err "
          + ", ".join(f"{k} {v:.2e} ({ratios[k]:.3f} x tol, |ref| max {absmax[k]:.2f})"
                      for k, v in errs.items()), flush=True)
    if not all(math.isfinite(r) and r <= 1.0 for r in ratios.values()):
        raise AssertionError(f"card and CPU ClipSeg disagree: {ratios} (tol {TOL_CLIPSEG})")
    del pred, cpu
    return result


def preprocess_clipseg_phase(dev, paths, scene: Path, root: Path):
    """``python -m samnerf_tpu_torch.preprocessing.get_clipseg_embeddings``
    (its ``main``) on the scene whose SAM targets ``preprocess_phase``
    extracted, the port's feature loader on its files, and 3
    ``samnerf_distill`` steps on both targets the port wrote."""
    import shutil

    from samnerf_tpu_torch.data.feature_loader import clipseg_pt_to_grid, load_features
    from samnerf_tpu_torch.preprocessing import get_clipseg_embeddings
    from samnerf_tpu_torch.scripts.profile_train import build_trainer

    shutil.rmtree(scene / "clipseg_features")        # the synthetic targets
    t0 = time.perf_counter()
    get_clipseg_embeddings.main([str(scene), "--clipseg-checkpoint", str(paths[1]),
                                 "--clip-checkpoint", str(paths[0])])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    files = sorted((scene / "clipseg_features").glob("*.pt"))
    obj = torch.load(files[0], map_location="cpu", weights_only=False)
    if len(files) != 24 or obj["visual_q"] is not None or [
            (tuple(a.shape), a.dtype) for a in obj["activations"]] != \
            [((1025, 1, 64), torch.float32)] * 3:
        raise AssertionError(f"{len(files)} ClipSeg files, the first {obj}")
    grids = load_features(files, get_feature=clipseg_pt_to_grid)
    if grids.shape != (24, 32, 32, 192) or not np.isfinite(grids).all():
        raise AssertionError(f"ClipSeg grids {grids.shape} or not finite")
    sam = load_features(sorted((scene / "sam_features").glob("*.npy")))
    trainer = build_trainer(scene, root / "out_clipseg", dev)
    if not (np.array_equal(trainer.datamanager.clipseg_features, grids)
            and np.array_equal(trainer.datamanager.sam_features, sam)):
        raise AssertionError("the trainer's targets are not the extracted features")
    losses = []
    trainer.cfg.max_num_iterations = 3
    trainer.train(step_callback=lambda step, m: losses.append(
        {k: float(v) for k, v in m.items()}))
    del trainer
    if len(losses) != 3 or not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train steps on the extracted features: {losses}")
    result = dict(files=len(files), seconds=seconds, grid_std=float(grids.std()),
                  losses=losses)
    print(f"preprocess_clipseg: get_clipseg_embeddings wrote {len(files)} files of 3 x "
          f"[1025, 1, 64] f32 in {seconds:.1f} s; 3 samnerf_distill steps on the SAM and "
          f"ClipSeg targets the port wrote, clipseg_loss "
          f"{losses[0].get('clipseg_loss', float('nan')):.4f} -> "
          f"{losses[-1].get('clipseg_loss', float('nan')):.4f}", flush=True)
    return result


def no_distill_view_phase(dev, checkpoint: Path, paths, size=VIEW_SIZE, chunk=1 << 15):
    """``render_view`` of the ``samnerf_no_distill`` preset's model at full
    width (seeded, ``static`` preset) with a ``LanguageSAM`` over the seeded
    ViT-H checkpoint and the seeded ClipSeg: a click view, three moved views
    with the click locked, one further view with a text prompt.  Raises
    unless FLASH-RELPOS runs 4 times in each view (ViT-H on the rendered
    rgb) and the mask decode got the heatmap's points followed by the
    locked point wherever it lies in bounds.  The branch draws no pins,
    as the JAX package's does not."""
    from samnerf_tpu_torch.configs.methods import method_configs
    from samnerf_tpu_torch.engine.render_pipeline import (SamNerfRenderer,
                                                          cameras_from_intrin_c2w, project)
    from samnerf_tpu_torch.models.sam_model import SAMModel, init_params
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.langsam import LanguageSAM
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w

    cfg = method_configs()["samnerf_no_distill"].model
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0), device=dev))
    lang = LanguageSAM(SamPredictor(build_sam("vit_h", checkpoint=str(checkpoint), device=dev)),
                       _clipseg_predictor(paths, dev))
    snr = SamNerfRenderer(model, lang_sam=lang, chunk=chunk, serve_preset="static")
    decoded = _record_points(lang.predictor)
    intrin = VIEW_INTRIN * (size / VIEW_SIZE)
    intrin[2, 2] = 1.0
    p0 = np.array([1.2 * np.cos(0.3), 1.2 * np.sin(0.3), 0.45])
    click = np.array([[float(int(0.45 * size)), float(int(0.55 * size))]])
    rows = []

    def view(i, c2w, text=None):
        cams = cameras_from_intrin_c2w(intrin, c2w, size, size, device=dev)
        ta.flash_attention_relpos.launches = 0
        _reset_encode_launches(hg)
        decoded.clear()
        t0 = time.perf_counter()
        out = snr.render_view(cams, 0, intrin, c2w, points=click, text_prompt=text)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_encode_launches(hg), **{"FLASH-RELPOS": ta.flash_attention_relpos.launches})
        for k in ("rgb", "depth", "masked_rgb"):
            if out[k].shape[:2] != (size, size) or not np.isfinite(out[k]).all():
                raise AssertionError(f"no-distill view {i} {k}: {out[k].shape} or not finite")
        heat = out.get("clipseg_feature")
        if heat is None or heat.shape != (512, 512, 1) or heat.min() < 0.0 or heat.max() > 1.0:
            raise AssertionError(f"no-distill view {i}: clipseg_feature "
                                 f"{None if heat is None else heat.shape} or not in [0, 1]")
        pins = project(intrin, c2w, snr.prompts)
        legal = ((pins >= 0) & (pins < size)).all(-1)
        got = decoded[0] if len(decoded) == 1 else np.zeros((0, 2))
        n_legal = int(legal.sum())
        if len(decoded) != 1 or not np.array_equal(got[len(got) - n_legal:],
                                                   pins[legal].astype(np.float64)):
            raise AssertionError(f"no-distill view {i}: the mask decode got {got.tolist()}, "
                                 f"not the heatmap's points and the pins {pins[legal].tolist()}")
        changed = np.abs(out["masked_rgb"] - out["rgb"]).max(-1) > 1e-6
        row = dict(view=i, text_prompt=text, ms=ms, pins=pins.tolist(), in_bounds=legal.tolist(),
                   heat_points=len(got) - n_legal, mask_fraction=float(changed.mean()),
                   launches=launches)
        rows.append(row)
        print(f"no_distill view {i} {size}x{size}{' text' if text else ''}: {ms:.1f} ms, pins "
              f"{row['pins']} in bounds {row['in_bounds']}, {row['heat_points']} heatmap "
              f"points, mask covers {100 * row['mask_fraction']:.1f} % of the frame; launches "
              + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
        if launches["FLASH-RELPOS"] != 4:
            raise AssertionError(f"no-distill view {i}: {launches['FLASH-RELPOS']} "
                                 "FLASH-RELPOS launches, not 4")

    c2w0 = look_at_c2w(p0, np.zeros(3))
    view(0, c2w0)
    step = (snr.prompts[0] - p0) / np.linalg.norm(snr.prompts[0] - p0)
    for i in (1, 2, 3):
        view(i, look_at_c2w(p0 + 0.05 * i * step + [0.0, 0.0, 0.02 * i], np.zeros(3)))
    view(4, look_at_c2w(p0 + 0.2 * step + [0.0, 0.0, 0.1], np.zeros(3)), CLIPSEG_PROMPTS[1])
    if not all(r["in_bounds"] == [True] for r in rows[:4]):
        raise AssertionError(f"the locked click left the frame: {rows[:4]}")
    timed = [r["ms"] for r in rows[1:4]]
    launches = sum(r["launches"]["FLASH-RELPOS"] for r in rows)
    result = dict(views=rows, view_ms=statistics.median(timed), view_ms_all=timed,
                  click_view_ms=rows[0]["ms"], text_view_ms=rows[4]["ms"],
                  launches=launches, launches_per_view=launches / len(rows))
    print(f"no_distill view: median {result['view_ms']:.1f} ms per moved view "
          f"({', '.join(f'{t:.1f}' for t in timed)}), click view {rows[0]['ms']:.1f} ms, "
          f"text view {rows[4]['ms']:.1f} ms; FLASH-RELPOS 4 launches per view", flush=True)
    del snr, model, lang
    return result


def no_distill_train_phase(dev, scene: Path, root: Path):
    """``NO_DISTILL_TRAIN_STEPS`` full-width ``samnerf_no_distill`` steps
    through ``Trainer`` on the synthetic scene: losses finite, ms per step
    after the first, launches per step."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts.profile_train import build_trainer

    trainer = build_trainer(scene, root / "out_no_distill", dev, method="samnerf_no_distill")
    losses, times, t_prev = [], [], [0.0]

    def on_step(step, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
            _reset_encode_launches(hg)
        else:
            times.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now

    trainer.cfg.max_num_iterations = NO_DISTILL_TRAIN_STEPS
    trainer.train(step_callback=on_step)
    steps = len(times)
    launches = {"F32-ENC": hg.parity_hash_encode.launches,
                "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    rays = trainer.datamanager.config.train_num_rays_per_batch
    del trainer
    result = dict(steps=len(losses), step_ms=statistics.median(times), step_ms_all=times,
                  rays_per_s=rays / statistics.median(times) * 1e3, launches=launches,
                  launches_per_step={k: v / steps for k, v in launches.items()},
                  max_memory_allocated=peak, first_losses=losses[0], last_losses=losses[-1])
    print(f"train samnerf_no_distill {rays} rays/step: {len(losses)} steps, median step "
          f"{result['step_ms']:.2f} ms over the last {steps}, "
          f"{result['rays_per_s']:,.0f} rays/s; launches/step "
          + ", ".join(f"{k}={v:g}" for k, v in result["launches_per_step"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB; losses first {losses[0]} "
          f"last {losses[-1]}", flush=True)
    if len(losses) != NO_DISTILL_TRAIN_STEPS or not all(
            math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"samnerf_no_distill train losses: {losses}")
    if not launches["F32-ENC"] or not launches["F32-ENC-BWD"]:
        raise AssertionError(f"the no-distill train path launched {launches}")
    return result


# --- eval and checkpoints ---------------------------------------------------

EVAL_STEPS = 4                  # train steps of the eval phase's run
EVAL_BATCH_EVERY, EVAL_IMAGE_EVERY = 2, 3   # eval batches at 2 and 4, an image at 3
EVAL_IMAGES = 5                 # timed eval images after a warm-up
LPIPS_CALLS = 5                 # timed LPIPS calls at 512x512
# LPIPS card vs CPU: thirteen f32 3x3 convolutions (TF32 off) summed in
# other orders; the distance is O(0.1-1)
TOL_LPIPS = 1e-4
# image metrics of a small model card vs CPU (psnr in dB, ssim in [-1, 1]):
# the rendered rgb differs by ~1e-6 (TOL_FRAME's reasoning)
TOL_METRIC = 1e-4


def lpips_weights(root: Path):
    """Seeded LPIPS weights in the reference layouts, written to ``root``:
    torchvision VGG16's ``features.*`` (He-normal convolutions, 14.7 M
    parameters) and the lpips package's ``lin{i}.model.1.weight`` heads
    (non-negative)."""
    from samnerf_tpu_torch.utils import metrics

    rng = np.random.default_rng(4)
    vgg, lin = {}, {}
    for name, t in metrics.LPIPS(device="meta").state_dict().items():
        shape = tuple(t.shape)
        if name.startswith("lins."):
            lin[f"lin{name.split('.')[1]}.model.1.weight"] = torch.from_numpy(
                np.abs(rng.normal(0.0, 0.1, shape)).astype(np.float32))
        elif name.endswith("bias"):
            vgg[name] = torch.from_numpy(rng.normal(0.0, 0.01, shape).astype(np.float32))
        else:
            vgg[name] = torch.from_numpy(rng.normal(
                0.0, math.sqrt(2.0 / np.prod(shape[1:])), shape).astype(np.float32))
    paths = (root / "vgg16-397923af.pth", root / "lpips_vgg.pth")
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return tuple(str(p) for p in paths)


def eval_images_per_call(pipe, h: int, w: int) -> int:
    """F32-ENC launches of one eval image: each chunk of the renderer runs
    the proposal networks once and the nerfacto field once."""
    return math.ceil(h * w / pipe.renderer.chunk) * (
        pipe.model.config.num_proposal_iterations + 1)


def eval_phase(dev, size: int = 512):
    """The train entry at full ``samnerf_distill`` width on a synthetic
    ``size``^2 scene (24 train and 2 test images) with both eval cadences
    firing and ``vis="json"``: the events in ``metrics.json``, F32-ENC and
    F32-ENC-BWD launches of the run against its steps, eval batches and
    eval images; ms per eval image, PSNR, SSIM, peak memory and F32-ENC
    launches per eval image against the renderer's chunking;
    ``scripts/eval.py``'s ``main`` on the run directory; LPIPS from seeded
    weights found through ``LPIPS_VGG_WEIGHTS`` / ``LPIPS_LIN_WEIGHTS``
    (ms at ``size``^2, card against CPU); the checkpoint reloaded through
    ``TrainerConfig.load_dir``, bit for bit; a small model's eval image
    metrics on the card against the CPU."""
    import os

    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR, Trainer
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts import eval as eval_script
    from samnerf_tpu_torch.utils import metrics, writer
    from samnerf_tpu_torch.utils.eval_utils import find_latest_checkpoint
    from samnerf_tpu_torch.utils.synthetic import write_scene

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scene = write_scene(root / "scene", num_train=24, num_test=2, h=size, w=size,
                            with_features=True, feature_long_side=64)
        run = root / "run"
        config = train_entry.parse([
            "samnerf_distill", "--data", str(scene), "--vis", "json",
            "--trainer.max-num-iterations", str(EVAL_STEPS),
            "--trainer.steps-per-eval-batch", str(EVAL_BATCH_EVERY),
            "--trainer.steps-per-eval-image", str(EVAL_IMAGE_EVERY),
            "--trainer.steps-per-save", "100000", "--trainer.output-dir", str(run)])
        train_entry.save_config(config)
        _reset_encode_launches(hg)
        t0 = time.perf_counter()
        trainer = train_entry.train_loop(config, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = {"F32-ENC": hg.parity_hash_encode.launches,
                        "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                        "Q-ENC": hg.parity_hash_encode_q8.launches}
        pipe = trainer._pipeline()
        per_image = eval_images_per_call(pipe, size, size)
        n_batches, n_images = EVAL_STEPS // EVAL_BATCH_EVERY, EVAL_STEPS // EVAL_IMAGE_EVERY
        want = {"F32-ENC": F32_PER_STEP * EVAL_STEPS + 2 * n_batches + per_image * n_images,
                "F32-ENC-BWD": F32_PER_STEP * EVAL_STEPS, "Q-ENC": 0}
        if run_launches != want:
            raise AssertionError(f"the train entry with eval launched {run_launches}, not "
                                 f"{want} ({EVAL_STEPS} steps, {n_batches} eval batches, "
                                 f"{n_images} eval images of {per_image})")
        rows = json.loads((run / "metrics.json").read_text())
        steps = {}
        for r in rows:
            steps.setdefault(r["name"], []).append(r["step"])
        events = {k: steps.get(k) for k in ("Eval Loss", "Test PSNR",
                                            "Eval Images Metrics/psnr")}
        if events != {"Eval Loss": [2, 4], "Test PSNR": [3],
                      "Eval Images Metrics/psnr": [3]} or not all(
                          math.isfinite(r["value"]) for r in rows):
            raise AssertionError(f"metrics.json events {events}")
        print(f"eval: train entry {EVAL_STEPS} steps with eval batches every "
              f"{EVAL_BATCH_EVERY} and an eval image every {EVAL_IMAGE_EVERY} in "
              f"{run_s:.1f} s; launches {run_launches}; metrics.json rows {len(rows)}, "
              f"events {events}", flush=True)

        # eval images: ms, metrics, peak memory, F32-ENC launches per image
        pipe.get_eval_image_metrics_and_images(0)                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_encode_launches(hg)
        times, per = [], []
        for i in range(EVAL_IMAGES):
            t0 = time.perf_counter()
            m, images = pipe.get_eval_image_metrics_and_images(i % 2)
            times.append((time.perf_counter() - t0) * 1e3)
            per.append(m)
        image_launches = _encode_launches(hg)
        image_peak = torch.cuda.max_memory_allocated()
        if image_launches != {"F32-ENC": per_image * EVAL_IMAGES, "Q-ENC": 0,
                              "FUSED-QMLP": 0}:
            raise AssertionError(f"{image_launches} for {EVAL_IMAGES} eval images, not "
                                 f"{per_image} F32-ENC per image")
        if images["img"].shape != (size, 2 * size, 3) or not all(
                math.isfinite(m["psnr"]) and -1.0 <= m["ssim"] <= 1.0 for m in per):
            raise AssertionError(f"eval images: {per}, img {images['img'].shape}")

        # scripts/eval.py on the run directory
        out = root / "eval.json"
        t0 = time.perf_counter()
        if eval_script.main([str(run), "--output", str(out)], device=dev) != 0:
            raise AssertionError("scripts/eval.py failed")
        script_s = time.perf_counter() - t0
        result_json = json.loads(out.read_text())
        ref = {k: float(np.mean([per[i][k] for i in (0, 1)])) for k in ("psnr", "ssim")}
        got = result_json["results"]
        if got["num_images"] != 2 or any(
                abs(got[k] - ref[k]) > TOL_METRIC * max(abs(ref[k]), 1.0) for k in ref):
            raise AssertionError(f"scripts/eval.py gave {got}, the pipeline {ref}")

        # LPIPS from seeded weights, found through the environment
        vgg_path, lin_path = lpips_weights(root)
        saved = {k: os.environ.get(k) for k in ("LPIPS_VGG_WEIGHTS", "LPIPS_LIN_WEIGHTS")}
        os.environ["LPIPS_VGG_WEIGHTS"], os.environ["LPIPS_LIN_WEIGHTS"] = vgg_path, lin_path
        try:
            pipe._lpips = None
            m_lpips, _ = pipe.get_eval_image_metrics_and_images(0)
            model = metrics.load_lpips_params(device=dev)
            model_cpu = metrics.load_lpips_params(device="cpu")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if "lpips" not in m_lpips or model is None:
            raise AssertionError(f"no lpips metric with weights present: {m_lpips}")
        gt = torch.as_tensor(pipe.datamanager.eval_images[0], device=dev).float() / 255.0
        pred = pipe.renderer.render_image_device(pipe._eval_cameras, 0, size, size,
                                                 minimal=True)["rgb"]
        torch.cuda.reset_peak_memory_stats()
        lpips_ms = _time_ms(lambda: metrics.lpips(pred, gt, model), LPIPS_CALLS)
        lpips_peak = torch.cuda.max_memory_allocated()
        lpips_card = metrics.lpips(pred, gt, model).item()
        lpips_cpu = metrics.lpips(pred.cpu(), gt.cpu(), model_cpu).item()
        lpips_err = abs(lpips_card - lpips_cpu) / max(abs(lpips_cpu), 1e-12)
        if not math.isfinite(lpips_card) or lpips_err > TOL_LPIPS:
            raise AssertionError(f"LPIPS card {lpips_card} vs CPU {lpips_cpu}")

        # the checkpoint back through TrainerConfig.load_dir, bit for bit
        ckpt_path = find_latest_checkpoint(run / CKPT_DIR)
        saved_ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        reloaded = Trainer(config.model, dataclasses.replace(config.trainer,
                                                             load_dir=run / CKPT_DIR),
                           config.optimizers, DataManager(config.datamanager), device=dev)
        bits = _same_bits(saved_ckpt["model"], reloaded.model.state_dict()) and \
            _same_bits(saved_ckpt["model"], trainer.model.state_dict()) and \
            _same_bits(saved_ckpt["optimizer"]["optimizer"]["state"],
                       reloaded.optimizer.state_dict()["optimizer"]["state"]) and \
            _same_bits(saved_ckpt["optimizer"]["optimizer"]["state"],
                       trainer.optimizer.state_dict()["optimizer"]["state"])
        if not bits or reloaded.state.step != EVAL_STEPS or \
                reloaded.optimizer.count != trainer.optimizer.count:
            raise AssertionError(f"the checkpoint {ckpt_path.name} did not round-trip")
        del trainer, reloaded, pipe
        writer.reset()
    reference = eval_reference_phase(dev)
    result = dict(run_s=run_s, run_launches=run_launches, metrics_json_rows=len(rows),
                  events=events, image_ms=statistics.median(times), image_ms_all=times,
                  images=EVAL_IMAGES, launches=image_launches,
                  launches_per_image=image_launches["F32-ENC"] / EVAL_IMAGES,
                  max_memory_allocated=image_peak, metrics=per, eval_script=result_json,
                  eval_script_s=script_s, lpips_ms=lpips_ms, lpips_max_memory_allocated=
                  lpips_peak, lpips=lpips_card, lpips_cpu=lpips_cpu, lpips_rel_err=lpips_err,
                  lpips_metric=m_lpips["lpips"], checkpoint=ckpt_path.name,
                  checkpoint_bits_equal=bits, reference=reference)
    print(f"eval: {size}x{size} eval image median {result['image_ms']:.2f} ms over "
          f"{EVAL_IMAGES} ({', '.join(f'{t:.1f}' for t in times)}); psnr "
          f"{per[0]['psnr']:.3f} / {per[1]['psnr']:.3f}, ssim {per[0]['ssim']:.4f} / "
          f"{per[1]['ssim']:.4f}; F32-ENC launches/image {result['launches_per_image']:g}; "
          f"max_memory_allocated={image_peak / 2**30:.2f} GiB; scripts/eval.py "
          f"{script_s:.1f} s: {result_json['results']}; LPIPS {size}x{size} {lpips_ms:.2f} "
          f"ms ({lpips_peak / 2**30:.2f} GiB), card {lpips_card:.6f} vs CPU "
          f"{lpips_cpu:.6f} (rel {lpips_err:.2e}, tol {TOL_LPIPS:g}); checkpoint "
          f"{ckpt_path.name} reloaded through load_dir bit for bit", flush=True)
    return result


def _same_bits(a, b) -> bool:
    """Nested dicts of tensors equal bit for bit (keys and values)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_bits(a[k], b[k]) for k in a)
    return torch.equal(a.cpu(), b.cpu())


def eval_reference_phase(dev):
    """A small model's eval image (64x64 synthetic scene, seeded weights,
    tables at +-0.5) through ``VanillaPipeline`` on the card against the
    CPU: rgb within TOL_FRAME, psnr and ssim within TOL_METRIC, F32-ENC
    launches per image on the card."""
    from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.engine.pipeline import VanillaPipeline
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.utils.init import init_state
    from samnerf_tpu_torch.utils.synthetic import write_scene

    cfg = SAMModelConfig(**SMALL_MODEL, far_plane=6.0)
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(Path(tmp) / "scene", num_train=2, num_test=2, h=64, w=64)
        dm = DataManager(DataManagerConfig(
            dataparser=DataparserConfig(data=scene, train_val_json_split=True)))
        outs = {}
        for d in (dev, "cpu"):
            model = SAMModel(cfg, device=d)
            model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                             torch.Generator().manual_seed(1), device=d,
                                             table_scale=0.5))
            pipe = VanillaPipeline(model, dm)
            _reset_encode_launches(hg)
            m, images = pipe.get_eval_image_metrics_and_images(1)
            outs[str(d)] = (m, images, hg.parity_hash_encode.launches,
                            eval_images_per_call(pipe, 64, 64))
    (ma, ia, launches, per_image), (mb, ib, _, _) = outs[str(dev)], outs["cpu"]
    rgb_err = float(np.abs(ia["img"] - ib["img"]).max())
    metric_err = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-12) for k in ("psnr", "ssim")}
    report = dict(rgb_max_abs_err=rgb_err, metric_rel_err=metric_err, card=ma, cpu=mb,
                  launches=launches)
    print(f"eval reference: 64x64 eval image card vs CPU rgb max abs err {rgb_err:.2e} "
          f"(tol {TOL_FRAME:g}), psnr {ma['psnr']:.4f} / {mb['psnr']:.4f}, ssim "
          f"{ma['ssim']:.5f} / {mb['ssim']:.5f} (rel err {metric_err}); F32-ENC launches "
          f"{launches}", flush=True)
    if rgb_err > TOL_FRAME or max(metric_err.values()) > TOL_METRIC \
            or launches != per_image:
        raise AssertionError(f"card and CPU eval images disagree: {report}")
    return report


# --- the automatic mask generator -------------------------------------------

AMG_FULL = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0, crop_n_layers=1)
AMG_CROPS = 5                   # the image and the four crops of layer 1


def amg_phase(dev, checkpoint: Path, images):
    """``SamAutomaticMaskGenerator(SamPredictor(build_sam_vit_h(ckpt)))`` on
    a 512x512 frame: with the JAX package's defaults (ms, masks; random
    weights may give few or none), then with the IoU and stability filters
    off and one crop layer, so that every step runs over 5 crops (ms per
    ``generate``, masks, peak memory, 4 FLASH-RELPOS launches per
    ``set_image``); then a small SAM's ``generate`` on the card against the
    CPU."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.automatic_mask_generator import \
        SamAutomaticMaskGenerator
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam_vit_h
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    predictor = SamPredictor(build_sam_vit_h(str(checkpoint), device=dev))
    image = images[1]
    runs = {}
    for tag, kw, crops in (("defaults", {}, 1), ("full", AMG_FULL, AMG_CROPS)):
        gen = SamAutomaticMaskGenerator(predictor, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ta.flash_attention_relpos.launches = 0
        t0 = time.perf_counter()
        anns = gen.generate(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = ta.flash_attention_relpos.launches
        peak = torch.cuda.max_memory_allocated()
        if launches != 4 * crops:
            raise AssertionError(f"AMG {tag}: FLASH-RELPOS launched {launches} times over "
                                 f"{crops} crops, not 4 per set_image")
        if not all(a["segmentation"].shape == image.shape[:2]
                   and a["area"] == int(a["segmentation"].sum())
                   and math.isfinite(a["predicted_iou"]) for a in anns):
            raise AssertionError(f"AMG {tag}: a malformed annotation")
        runs[tag] = dict(ms=ms, masks=len(anns), launches=launches,
                         max_memory_allocated=peak,
                         crops=sorted({tuple(a["crop_box"]) for a in anns}))
        print(f"amg {tag} ({kw or 'JAX defaults'}): generate {ms:.1f} ms, {len(anns)} masks "
              f"from {len(runs[tag]['crops'])} of {crops} crops, FLASH-RELPOS launches "
              f"{launches}; max_memory_allocated={peak / 2**30:.2f} GiB", flush=True)
    if runs["full"]["masks"] == 0:
        raise AssertionError("AMG with the filters off kept no mask")
    del predictor
    reference = amg_reference_phase(dev)
    return dict(runs=runs, launches=runs["full"]["launches"], reference=reference)


def small_sam(device):
    """A seeded SAM with ``SMALL_ENCODER`` (its global layer over
    FLASH-RELPOS on the card)."""
    from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
    from samnerf_tpu_torch.perception.sam.sam import Sam
    from samnerf_tpu_torch.utils.init import init_state

    meta = Sam(image_encoder=ImageEncoderViT(**SMALL_ENCODER, device="meta"), device="meta")
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL_ENCODER, device=device), device=device)
    sam.load_state_dict(init_state(meta, torch.Generator().manual_seed(0), device))
    return sam


def amg_reference_phase(dev):
    """A small SAM's ``generate`` (96x128 frame, 16 points, filters and box
    NMS off, so every mask stays) on the card against the CPU: the same
    number of annotations, each card mask at IoU >= 0.99 with the CPU mask
    of its prompt point that matches it best, boxes within 1 px."""
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.perception.sam.automatic_mask_generator import \
        SamAutomaticMaskGenerator
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    image = np.random.default_rng(2).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, box_nms_thresh=1.0)
    ta.flash_attention_relpos.launches = 0
    card = SamAutomaticMaskGenerator(SamPredictor(small_sam(dev)), **kw).generate(image)
    launches = ta.flash_attention_relpos.launches
    cpu = SamAutomaticMaskGenerator(SamPredictor(small_sam("cpu")), **kw).generate(image)
    worst_iou, worst_box = 1.0, 0.0
    for a in card:
        same_point = [b for b in cpu if np.allclose(b["point_coords"], a["point_coords"])]
        ious = [np.logical_and(a["segmentation"], b["segmentation"]).sum()
                / max(np.logical_or(a["segmentation"], b["segmentation"]).sum(), 1)
                for b in same_point] or [0.0]
        best = int(np.argmax(ious))
        worst_iou = min(worst_iou, float(ious[best]))
        if same_point:
            worst_box = max(worst_box, float(np.abs(np.subtract(
                a["bbox"], same_point[best]["bbox"])).max()))
    report = dict(masks_card=len(card), masks_cpu=len(cpu), worst_iou=worst_iou,
                  worst_box_px=worst_box, launches=launches)
    print(f"amg reference: small SAM 96x128 card vs CPU {len(card)} / {len(cpu)} masks, "
          f"worst matched IoU {worst_iou:.5f}, worst box diff {worst_box:g} px; "
          f"FLASH-RELPOS launches {launches}", flush=True)
    if len(card) != len(cpu) or len(card) != 16 * 3 or worst_iou < 0.99 \
            or worst_box > 1.0 or launches != 1:
        raise AssertionError(f"card and CPU masks disagree: {report}")
    return report


# --- serve culling and the viewer ------------------------------------------

CULL_RES = 96                   # the presets' occ_res
CULL_BALL = 0.25                # the synthetic grid: cells in this ball about the centre
CULL_EPS = 1e-2                 # serve_transmittance_eps of the early-termination run
CULL_FRAMES = 3                 # timed frames per culling setting, after a warm-up
# early termination card vs CPU: an eps that every transmittance estimate
# of the small frame keeps ETA_MARGIN from (f32 sums of 64 weights in two
# orders differ by < 4e-6), so no sample flips on rounding
ETA_CANDIDATES = (1e-2, 1.2e-2, 8e-3, 1.5e-2, 6e-3)
ETA_MARGIN = 1e-5
# a JPEG (quality 70) of a frame against the frame: mean abs error in [0, 1]
TOL_JPEG = 0.03
CULL_REF_FOCAL = 100.0          # the small culled frame's focal length (64 px wide)
VIEWER_TIMEOUT = 60.0           # seconds for any expected viewer message
VIEWER_MOVES = 3


def _ball_cells(radius=CULL_BALL):
    """[CULL_RES]^3 0/1 cells inside a ball of ``radius`` about the unit
    cube's centre."""
    c = (np.arange(CULL_RES) + 0.5) / CULL_RES - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x * x + y * y + z * z <= radius * radius).astype(np.float32)


@contextlib.contextmanager
def _culled_share():
    """Count the culled and all samples of the fields' ``_cull`` by level
    (the nerf field passes ``live_in``, the proposal networks do not); it
    reads a count back per call, so no frame inside is timed."""
    from samnerf_tpu_torch.fields import nerfacto_field

    counts, cull = {"proposal": [0, 0], "nerf": [0, 0]}, nerfacto_field._cull

    def counted(p, occ, occ_res, *live_in):
        flat, live = cull(p, occ, occ_res, *live_in)
        c = counts["nerf" if live_in else "proposal"]
        c[1] += p.shape[0] * p.shape[1]
        if live is not None:
            c[0] += int((live == 0).sum())
        return flat, live

    nerfacto_field._cull = counted
    try:
        yield counts
    finally:
        nerfacto_field._cull = cull


def _share(counts):
    """The culled share of samples per level."""
    return {k: c[0] / max(c[1], 1) for k, c in counts.items()}


def _serve_ms(serve, cams, click, frames=CULL_FRAMES):
    serve(cams, 0, click)
    torch.cuda.synchronize()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        serve(cams, 0, click)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def cull_phase(dev, cfg=None, size=VIEW_SIZE):
    """Serve culling at full ``samnerf_distill`` width (seed 0, morton):
    ``SamNerfRenderer.bake_occupancy`` at res 96, sub 2 on the f32 and the
    baked int8 fused model (ms, occupied fraction, launches); an
    all-occupied grid gives the un-culled ``serve_frame_fn`` frame and grids
    bit for bit with f32, int8 and int8 fused tables; a synthetic grid (a
    ball of radius 0.25 about the centre) on the int8 fused model: the
    share of proposal and nerf samples culled per frame, frame ms with and
    without it, launches; the same with ``serve_transmittance_eps`` 1e-2
    (and peak memory); a small model's culled 64x64 frame (grid and early
    termination) on the card against the CPU.  ``cfg`` replaces the full
    width (a rehearsal's small model).  Returns (the report, the int8
    fused model for the viewer phase)."""
    from samnerf_tpu_torch.engine.eval_render import occupancy_from_cells
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.occupancy import pack_serve_occupancy
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    H = W = size
    cfg = cfg or SAMModelConfig(hash_fn="morton")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    cams = _cameras(dev, 0, H, W, 400.0 * size / VIEW_SIZE)
    click = (size / 2.0, size / 2.0)
    full = pack_serve_occupancy(np.ones((CULL_RES,) * 3, np.float32), device=dev)
    report = {"bake": {}, "identity": {}}
    fused = None
    for tag, q8, fuse in SERVE_RUNS:
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        outs = []
        for occ in (None, full):
            snr.occ = occ
            img, mask = snr.serve_frame_fn(sam, H, W)(cams, 0, click, return_mask=True)
            grids = snr.renderer.render_image_device(cams, 0, W, H, ("sam", "clipseg"),
                                                     minimal=True, occ=occ)
            outs.append({"img": img, "mask": mask, **grids})
        same = {k: bool(torch.equal(outs[0][k], outs[1][k])) for k in outs[0]}
        report["identity"][tag] = same
        print(f"cull {tag}: an all-occupied {CULL_RES}^3 grid gives the un-culled frame "
              f"bit for bit: {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"an all-occupied grid changed the {tag} frame: {same}")
        del outs
        if tag in ("f32", "int8_fused"):
            torch.cuda.synchronize()
            _reset_encode_launches(hg)
            t0 = time.perf_counter()
            frac = snr.bake_occupancy(res=CULL_RES, sub=2)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _encode_launches(hg)
            report["bake"][tag] = dict(ms=ms, occupied=frac, launches=launches,
                                       points=CULL_RES ** 3 * 8)
            print(f"cull bake {tag}: {CULL_RES}^3 cells x 8 = {CULL_RES ** 3 * 8:,} points in "
                  f"2^17-point chunks, {ms:.1f} ms, occupied {frac:.4f}, launches "
                  + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
            if frac <= 0.0 or launches[{"f32": "F32-ENC", "int8_fused": "Q-ENC"}[tag]] != \
                    -(-CULL_RES ** 3 * 8 // (1 << 17)):
                raise AssertionError(f"the {tag} bake: occupied {frac}, launches {launches}")
        if tag == "int8_fused":
            fused = snr
        else:
            del snr, model
    snr = fused
    ball = _ball_cells()
    grid, frac = occupancy_from_cells(ball, 0.5, device=dev)
    report["ball_occupied"] = frac
    runs = {}
    for name, occ, eps in (("none", None, 0.0), ("grid", grid, 0.0), ("eps", None, CULL_EPS),
                           ("grid_eps", grid, CULL_EPS)):
        snr.occ = occ
        snr.renderer.model.config = dataclasses.replace(snr.renderer.model.config,
                                                        serve_transmittance_eps=eps)
        serve = snr.serve_frame_fn(sam, H, W)
        with _culled_share() as counts:
            img = serve(cams, 0, click)
        if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
            raise AssertionError(f"culled frame {img.dtype} {tuple(img.shape)}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_encode_launches(hg)
        ms, times = _serve_ms(serve, cams, click)
        launches = _encode_launches(hg)
        runs[name] = dict(frame_ms=ms, frame_ms_all=times, culled=_share(counts),
                          launches=launches,
                          launches_per_frame={k: v / (CULL_FRAMES + 1)
                                              for k, v in launches.items()},
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"cull {name:8s} {H}x{W} int8 fused: median frame {ms:.2f} ms "
              f"({', '.join(f'{t:.1f}' for t in times)}); culled "
              + ", ".join(f"{k} {100 * v:.1f} %" for k, v in runs[name]["culled"].items())
              + "; launches/frame " + " ".join(f"{k}={v:g}" for k, v in
                                              runs[name]["launches_per_frame"].items())
              + f"; max_memory_allocated={runs[name]['max_memory_allocated'] / 2**30:.2f} GiB",
              flush=True)
        if launches["FUSED-QMLP"] != FUSED_PER_FRAME * (CULL_FRAMES + 1) or launches["Q-ENC"] \
                or launches["F32-ENC"]:
            raise AssertionError(f"culled frames ({name}) launched {launches}")
    snr.occ = None
    snr.renderer.model.config = dataclasses.replace(snr.renderer.model.config,
                                                    serve_transmittance_eps=0.0)
    # at 512^2 a tile of the stream is 8 depths of a 32x32-pixel block: the
    # far proposal samples outside the ball form whole dead tiles
    if size == VIEW_SIZE and not runs["grid"]["culled"]["proposal"] > 0.0:
        raise AssertionError(f"the ball grid culled no proposal sample: {runs}")
    print(f"cull: the ball grid occupies {frac:.4f} of the cells", flush=True)
    report.update(runs=runs, small=cull_reference_phase(dev, ball))
    return report, snr.renderer.model


def cull_reference_phase(dev, cells):
    """A 64x64 frame of the small model (int8 fused, the presets' sample
    counts, 2048-ray chunks: the block-major stream, a narrow view so that
    whole tiles fall outside the ball) with the ball grid and early
    termination, on the card against the CPU."""
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.occupancy import pack_serve_occupancy
    from samnerf_tpu_torch.ops.samplers import proposal_sampling
    from samnerf_tpu_torch.core.cameras import generate_rays
    from samnerf_tpu_torch.engine.eval_render import _blocked_coords
    from samnerf_tpu_torch.utils.init import init_state

    # the presets' sample counts: a tile is then 8 of 64 proposal depths
    cfg = SAMModelConfig(**{**SMALL_MODEL, "num_proposal_samples_per_ray": (64,),
                            "num_nerf_samples_per_ray": 32},
                         hash_q8_serve=True, serve_fuse_mlp=True, occ_res=cells.shape[0])
    models = {}
    for d in ("cpu", dev):
        model = SAMModel(cfg, device=d)
        model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                         torch.Generator().manual_seed(1), device=d,
                                         table_scale=0.5))
        models[str(d)] = model
    grid_cpu = pack_serve_occupancy(cells, device="cpu")
    # the eps: every CPU transmittance estimate keeps ETA_MARGIN from it
    cams = _cameras("cpu", 1, 64, 64, CULL_REF_FOCAL)
    coords, _ = _blocked_coords(64, 64, 2048)
    t_est = []
    with torch.no_grad():
        m = models["cpu"]
        for c in torch.as_tensor(coords):
            rb = generate_rays(cams, torch.zeros(c.shape[0], dtype=torch.long), c)
            rb = rb.with_near_far(cfg.near_plane, cfg.far_plane)
            samples, wl, sl = proposal_sampling(
                rb, [lambda x, p=p: p(x, grid_cpu) for p in m.proposal_networks],
                cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray)
            pend = sl[-1].ends[..., 0]
            tmid = (samples.starts + samples.ends)[..., 0] * 0.5
            t_est.append(1.0 - torch.where(pend[:, None, :] <= tmid[:, :, None],
                                           wl[-1][..., 0][:, None, :], 0.0).sum(-1))
    t_est = torch.cat(t_est)
    eps = next(e for e in ETA_CANDIDATES if (t_est - e).abs().min() > ETA_MARGIN)
    outs = {}
    _reset_encode_launches(hg)
    for d, model in models.items():
        model.config = dataclasses.replace(model.config, serve_transmittance_eps=eps)
        renderer = SamNerfRenderer(model, chunk=2048, serve_preset="static").renderer
        with _culled_share() as counts:
            grids = renderer.render_image_device(_cameras(d, 1, 64, 64, CULL_REF_FOCAL), 0,
                                                 64, 64, ("sam", "clipseg"),
                                                 occ=pack_serve_occupancy(cells, device=d))
        outs[d] = ({k: v.cpu() for k, v in grids.items()}, _share(counts))
    launches = _encode_launches(hg)
    (a, share_a), (b, share_b) = outs[str(dev)], outs["cpu"]
    errs = {k: (a[k] - b[k]).abs().max().item() for k in ("rgb", "depth", "sam", "clipseg")}
    report = dict(eps=eps, grid_max_abs_err={k: v for k, v in errs.items() if k != "depth"},
                  depth_max_abs_err=errs["depth"], culled_card=share_a, culled_cpu=share_b,
                  launches=launches)
    print(f"cull reference: 64x64 small int8 fused frame, ball grid and eps {eps:g}, card vs "
          f"CPU grid max abs err {report['grid_max_abs_err']} (depth {errs['depth']:.2e}); "
          f"culled card {share_a}, CPU {share_b}; launches {launches}", flush=True)
    if max(report["grid_max_abs_err"].values()) > TOL_FRAME or share_a != share_b \
            or launches["FUSED-QMLP"] == 0:
        raise AssertionError(f"card and CPU culled frames disagree: {report}")
    if not share_a["proposal"] > 0.0:
        raise AssertionError(f"the small culled frame culled {share_a}")
    return report


def _look_at(eye) -> np.ndarray:
    """[4, 4] camera-to-world at ``eye`` looking at the origin."""
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w
    return look_at_c2w(np.asarray(eye, np.float64), np.zeros(3))


def _viewer_camera(m, eye, xs=(), moving=False, fov=65.0):
    """A client camera message whose pose looks at the origin from ``eye``
    (the client's column-major matrix; ``camera_from_message``'s two row
    swaps cancel, so the matrix's top rows are the c2w)."""
    mat = _look_at(eye)
    return m.CameraMessage(aspect=1.0, render_aspect=1.0, fov=fov,
                           matrix=tuple(mat.T.reshape(-1).tolist()),
                           camera_type="perspective", is_moving=moving,
                           timestamp=int(time.time() * 1e3), xs=list(xs), ys=[0.55] * len(xs))


def _jpeg(msg):
    import base64
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(msg.base64_data))),
                      np.float32) / 255.0


def _require_viewer_packages():
    missing = [n for n in ("websockets", "msgpack") if importlib.util.find_spec(n) is None]
    if missing:
        raise ModuleNotFoundError(f"the viewer phases need {', '.join(missing)}")


def viewer_phase(dev, model, root: Path, size=VIEW_SIZE):
    """The viewer over the cull phase's full-width int8 fused model
    (``static`` preset, a seeded ``SamPredictor``, ``max_res`` 512) on
    127.0.0.1 at a free port, driven by a ``websockets`` client in this
    process: the replayed scene box; a static camera (high, 512 on the
    long side), three moving ones (low_move at the dynamic resolution
    through the "move" renderer) and a static one (low_static, then the
    self-triggered high); "Output Render" = masked_rgb, SAM on and a click
    (one locked 3D point, the mask in the frame); a crop; a frame with the
    ball grid installed; a camera path saved through the client message
    and rendered by ``scripts/render.py --traj filename`` on a run
    directory saved from the model.  Each JPEG is held against the
    output ``render_view`` gave for it (mean abs error <= TOL_JPEG).
    ``stop()`` joins both threads."""
    _require_viewer_packages()
    import websockets.sync.client as wsc

    from samnerf_tpu_torch.engine.eval_render import occupancy_from_cells
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.viewer import messages as m
    from samnerf_tpu_torch.viewer.viewer_state import ViewerState

    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(2), device=dev))
    snr = SamNerfRenderer(model, sam_predictor=SamPredictor(sam), serve_preset="static")
    state = ViewerState(snr, host="127.0.0.1", port=0, max_res=size)
    state.camera_paths_dir = str(root / "camera_paths")
    renders = []
    render_view = state.render_view

    def recorded(intrin, c2w, h, w, **kw):
        before = _encode_launches(hg)
        rm = state.render_machine
        row = dict(state=rm.state, preset=kw.get("preset"), h=h, w=w,
                   expected=rm._calculate_image_res(1.0), output=state.output_render)
        t0 = time.perf_counter()
        out = render_view(intrin, c2w, h, w, **kw)
        row["render_ms"] = (time.perf_counter() - t0) * 1e3
        row["points"] = 0 if kw.get("points") is None else len(kw["points"])
        row["launches"] = {k: v - before[k] for k, v in _encode_launches(hg).items()}
        key = state.output_render if state.output_render in out else "rgb"
        row["image"] = np.clip(out[key], 0, 1)
        row["mask_fraction"] = float((np.abs(out["masked_rgb"] - out["rgb"]).max(-1)
                                      > 1e-6).mean())
        renders.append(row)
        return out

    state.render_view = recorded
    # the j-th image broadcast is the j-th the client receives: each notes
    # the render it shows
    frames, shown = [], []
    set_background_image = state.server.set_background_image

    def noted(image, **kw):
        shown.append(len(renders) - 1)
        return set_background_image(image, **kw)

    state.server.set_background_image = noted

    def expect_frame(ws, sent_at, what):
        deadline = time.time() + VIEWER_TIMEOUT
        while time.time() < deadline:
            try:
                msg = m.Message.deserialize(ws.recv(timeout=max(deadline - time.time(), 0.1)))
            except TimeoutError:
                break
            if isinstance(msg, m.BackgroundImageMessage):
                frames.append(dict(what=what, latency_ms=(time.perf_counter() - sent_at) * 1e3,
                                   image=_jpeg(msg), render=shown[len(frames)]))
                return frames[-1]
        raise AssertionError(f"viewer: no frame for {what} in {VIEWER_TIMEOUT} s")

    def send(ws, msg, what, n_frames=1):
        t0 = time.perf_counter()
        ws.send(msg.serialize())
        return [expect_frame(ws, t0, what) for _ in range(n_frames)]

    _reset_encode_launches(hg)
    torch.cuda.reset_peak_memory_stats()
    eye = np.array([1.2 * np.cos(0.3), 1.2 * np.sin(0.3), 0.45])
    result = {}
    try:
        state.start()
        state.init_scene()
        with wsc.connect(f"ws://127.0.0.1:{state.server.port}", max_size=None) as ws:
            deadline = time.time() + VIEWER_TIMEOUT
            while True:
                msg = m.Message.deserialize(ws.recv(timeout=max(deadline - time.time(), 0.1)))
                if isinstance(msg, m.SceneBoxMessage):
                    break
            send(ws, _viewer_camera(m, eye), "static")
            for i in range(VIEWER_MOVES):
                send(ws, _viewer_camera(m, eye * (1.0 - 0.03 * (i + 1)), moving=True), "move")
            send(ws, _viewer_camera(m, eye * 0.91), "stop", n_frames=2)
            ws.send(m.GuiUpdateMessage(name="Output Render", value="masked_rgb").serialize())
            ws.send(m.SamMessage(use_sam=True).serialize())
            # a queued rerender is never replaced, so the click's can be dropped
            # behind the toggles'; the client resends its camera with the click
            deadline = time.time() + VIEWER_TIMEOUT
            while snr.prompts is None and time.time() < deadline:
                send(ws, _viewer_camera(m, eye * 0.91, xs=[0.45]), "click")
            if snr.prompts is None or len(snr.prompts) != 1:
                raise AssertionError(f"viewer: the click locked {snr.prompts}")
            send(ws, m.CropParamsMessage(crop_enabled=True, crop_bg_color=(0, 0, 255),
                                         crop_center=(0.0, 0.0, 0.0),
                                         crop_scale=(1.5, 1.5, 1.5)), "crop")
            ws.send(m.CropParamsMessage(crop_enabled=False, crop_bg_color=(0, 0, 0),
                                        crop_center=(0.0, 0.0, 0.0),
                                        crop_scale=(2.0, 2.0, 2.0)).serialize())
            expect_frame(ws, time.perf_counter(), "uncrop")
            snr.occ, result["ball_occupied"] = occupancy_from_cells(_ball_cells(), 0.5,
                                                                    device=dev)
            send(ws, _viewer_camera(m, eye * 0.9, xs=[0.45]), "grid")
            snr.occ = None
            path = {"camera_type": "perspective", "render_height": 256, "render_width": 256,
                    "camera_path": [{"camera_to_world": _look_at(eye * s).reshape(-1).tolist(),
                                     "fov": 65.0, "aspect": 1.0} for s in (1.0, 0.95, 0.9)],
                    "fps": 24, "seconds": 1}
            ws.send(m.CameraPathPayloadMessage(camera_path_filename="smoke_path",
                                               camera_path=path).serialize())
            ws.send(m.CameraPathOptionsRequest().serialize())
            deadline = time.time() + VIEWER_TIMEOUT
            while True:
                msg = m.Message.deserialize(ws.recv(timeout=max(deadline - time.time(), 0.1)))
                if isinstance(msg, m.CameraPathsMessage) and "smoke_path.json" in msg.payload:
                    break
    finally:
        state.stop()
    if state.render_machine.is_alive() or state.server._thread is not None:
        raise AssertionError("viewer: stop() left a thread running")
    launches = _encode_launches(hg)
    peak = torch.cuda.max_memory_allocated()

    errs = [float(np.abs(f["image"] - renders[f["render"]]["image"]).mean()) for f in frames]
    states = [renders[f["render"]]["state"] for f in frames]
    want = (["high"] + ["low_move"] * VIEWER_MOVES + ["low_static", "high"])
    if states[:len(want)] != want:
        raise AssertionError(f"viewer: the frames' states {states}, not {want}")
    for f in frames:
        r = renders[f["render"]]
        if (r["h"], r["w"]) != r["expected"] or r["h"] % 32 or r["w"] % 32 or \
                f["image"].shape[:2] != (r["h"], r["w"]):
            raise AssertionError(f"viewer: frame {f['what']} {f['image'].shape} for "
                                 f"{r['state']} at {r['h']}x{r['w']}, expected {r['expected']}")
        if r["state"] == "high" and (r["h"], r["w"]) != (size, size):
            raise AssertionError(f"viewer: a high frame at {r['h']}x{r['w']}")
        if (r["preset"] == "move") != (r["state"] == "low_move"):
            raise AssertionError(f"viewer: {r['state']} rendered with preset {r['preset']}")
    if max(errs) > TOL_JPEG:
        raise AssertionError(f"viewer: JPEG against render_view's output: {errs}")
    if not any(renders[f["render"]]["output"] == "masked_rgb" and renders[f["render"]]["points"]
               and renders[f["render"]]["mask_fraction"] > 0.0 for f in frames):
        raise AssertionError("viewer: the click's mask reached no frame")
    rows = [{k: v for k, v in renders[f["render"]].items() if k != "image"}
            | dict(what=f["what"], latency_ms=f["latency_ms"], jpeg_mae=e)
            for f, e in zip(frames, errs)]
    by_state = {}
    for r in rows:
        by_state.setdefault(r["state"], []).append(r)
    summary = {s: dict(latency_ms=statistics.median(x["latency_ms"] for x in rs),
                       render_ms=statistics.median(x["render_ms"] for x in rs),
                       sizes=sorted({(x["h"], x["w"]) for x in rs}),
                       fused_per_frame=sorted({x["launches"]["FUSED-QMLP"] for x in rs}),
                       frames=len(rs)) for s, rs in by_state.items()}
    for s, v in summary.items():
        print(f"viewer {s:10s}: {v['frames']} frames, median message->image "
              f"{v['latency_ms']:.1f} ms (render_view {v['render_ms']:.1f} ms), sizes "
              f"{v['sizes']}, FUSED-QMLP per frame {v['fused_per_frame']}", flush=True)
    print(f"viewer: {len(frames)} frames, JPEG mean abs err max {max(errs):.4f} (tol "
          f"{TOL_JPEG}); 1 locked point; launches {launches}; max_memory_allocated="
          f"{peak / 2**30:.2f} GiB", flush=True)
    if launches["Q-ENC"] or launches["F32-ENC"] or launches["FUSED-QMLP"] != sum(
            r["launches"]["FUSED-QMLP"] for r in renders):
        raise AssertionError(f"viewer launched {launches}")
    result.update(frames=rows, renders=len(renders), by_state=summary, launches=launches,
                  max_memory_allocated=peak, jpeg_mae_max=max(errs),
                  render_path=render_path_phase(dev, model, root,
                                                Path(state.camera_paths_dir) / "smoke_path.json"))
    return result


def render_path_phase(dev, model, root: Path, path_file: Path):
    """``scripts/render.py --traj filename`` on the camera path the viewer
    saved, over a run directory holding the model's weights (a config
    and a checkpoint on a small synthetic scene): a frame per keyframe,
    the first equal to ``ImageRenderer``'s to one level."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.core.camera_paths import get_path_from_json
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.engine.trainer import Trainer
    from samnerf_tpu_torch.scripts import render as render_script
    from samnerf_tpu_torch.utils.synthetic import write_scene

    from PIL import Image

    scene = write_scene(root / "path_scene", num_train=2, num_test=1, h=64, w=64,
                        with_features=True, feature_long_side=16)
    run = root / "path_run"
    config = train_entry.parse(["samnerf_distill", "--data", str(scene), "--vis", "none",
                                "--trainer.output-dir", str(run)])
    train_entry.save_config(config)
    trainer = Trainer(config.model, config.trainer, config.optimizers,
                      DataManager(config.datamanager, seed=0), device=dev)
    baked = ("qtable8", "qscales8", "qtable4", "qscales4")
    weights = {k: v for k, v in model.state_dict().items() if k.rsplit(".", 1)[-1] not in baked}
    trainer.model.load_state_dict(weights)
    trainer.save_checkpoint(0)
    t0 = time.perf_counter()
    rc = render_script.main([str(run), "--traj", "filename", "--camera-path-filename",
                             str(path_file), "--output", str(root / "path_frames")], device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    frames = sorted((root / "path_frames").glob("frame_*.png"))
    cams = get_path_from_json(json.loads(path_file.read_text())).to(dev)
    ref = ImageRenderer(trainer.model).render_image(cams, 0)["rgb"]
    first = np.asarray(Image.open(frames[0])).astype(np.int64)
    diff = int(np.abs(first - (np.clip(ref, 0, 1) * 255).astype(np.int64)).max())
    print(f"render_path: scripts/render.py --traj filename wrote {len(frames)} frames "
          f"{first.shape} in {ms:.0f} ms; frame 0 against ImageRenderer max diff {diff}",
          flush=True)
    if rc != 0 or len(frames) != 3 or first.shape != (256, 256, 3) or diff > 1:
        raise AssertionError(f"render.py: rc {rc}, {len(frames)} frames, diff {diff}")
    del trainer
    return dict(ms=ms, frames=len(frames), max_diff=diff)


VIEWER_TRAIN_STEPS = 35         # the viewer re-renders every 30 steps


def viewer_train_phase(dev, scene: Path, root: Path, train_step_ms: float):
    """``train.train_loop`` with ``--vis viewer`` at full width on the
    train phase's synthetic scene, free ports, 35 steps (so the viewer's
    every-30-steps re-render fires).  The attach is watched: a failure
    raises after the run (no "viewer unavailable").  A client connects as
    the viewer starts, sends a camera and must get a frame before the last
    step ends.  Step ms with the viewer attached beside the train phase's,
    F32-ENC / F32-ENC-BWD launches against the steps and frames, finite
    losses, and the viewer stopped with the run."""
    _require_viewer_packages()
    import threading

    import websockets.sync.client as wsc
    from websockets.exceptions import ConnectionClosedOK

    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.viewer import messages as m

    config = train_entry.parse([
        "samnerf_distill", "--data", str(scene), "--vis", "viewer",
        "--websocket-port", "0", "--http-port", "0",
        "--trainer.max-num-iterations", str(VIEWER_TRAIN_STEPS),
        "--trainer.save-final", "false", "--trainer.output-dir", str(root / "out_viewer")])
    attached, failures, frames, renders = [], [], [], []
    done = threading.Event()
    launch = train_entry._launch_viewer

    def client(port):
        try:
            with wsc.connect(f"ws://127.0.0.1:{port}", max_size=None) as ws:
                ws.send(_viewer_camera(m, (1.3, 0.4, 0.5)).serialize())
                while not done.is_set():
                    try:
                        msg = m.Message.deserialize(ws.recv(timeout=0.5))
                    except TimeoutError:
                        continue
                    if isinstance(msg, m.BackgroundImageMessage):
                        frames.append((time.perf_counter(), _jpeg(msg).shape))
        except ConnectionClosedOK:
            pass                 # the viewer stops with the run
        except Exception as e:   # reported after the run
            failures.append(e)

    def watched(trainer, cfg):
        try:
            state = launch(trainer, cfg)
        except Exception as e:
            failures.append(e)
            raise
        render_view = state.render_view

        def counted(intrin, c2w, h, w, **kw):
            renders.append((h, w))
            return render_view(intrin, c2w, h, w, **kw)

        state.render_view = counted
        attached.append(state)
        thread = threading.Thread(target=client, args=(state.server.port,), daemon=True)
        thread.start()
        attached.append(thread)
        return state

    losses, times, t_prev, last_step = [], [], [0.0], [0.0]

    def on_step(step, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step > TRAIN_WARMUP:
            times.append((now - t_prev[0]) * 1e3)
        t_prev[0] = last_step[0] = now

    _reset_encode_launches(hg)
    train_entry._launch_viewer = watched
    try:
        trainer = train_entry.train_loop(config, device=dev, step_callback=on_step)
    finally:
        train_entry._launch_viewer = launch
        done.set()
    if failures or len(attached) != 2:
        raise AssertionError(f"viewer_train: the viewer did not attach or its client "
                             f"failed: {failures}")
    state, thread = attached
    thread.join(timeout=10)
    if thread.is_alive() or state.render_machine.is_alive() or state.server._thread is not None:
        raise AssertionError("viewer_train: a viewer or client thread outlived the run")
    launches = {"F32-ENC": hg.parity_hash_encode.launches,
                "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                "Q-ENC": hg.parity_hash_encode_q8.launches}
    del trainer
    before_end = [f for f in frames if f[0] <= last_step[0]]
    step_ms = statistics.median(times)
    result = dict(step_ms=step_ms, step_ms_all=times, train_phase_step_ms=train_step_ms,
                  steps=VIEWER_TRAIN_STEPS, frames=len(renders), frame_sizes=renders,
                  frames_received=len(frames), frames_before_end=len(before_end),
                  launches=launches, first_losses=losses[0], last_losses=losses[-1])
    print(f"viewer_train: {VIEWER_TRAIN_STEPS} steps with the viewer attached, median step "
          f"{step_ms:.2f} ms ({min(times):.1f}-{max(times):.1f}; train phase "
          f"{train_step_ms:.2f}); {len(renders)} viewer frames {sorted(set(renders))}, "
          f"{len(frames)} received, {len(before_end)} before the last step; launches "
          f"{launches}; losses first {losses[0]} last {losses[-1]}", flush=True)
    if not before_end:
        raise AssertionError("viewer_train: no frame reached the client during training")
    if not all(math.isfinite(v) for r in losses for v in r.values()):
        raise AssertionError(f"viewer_train losses: {losses}")
    if any(hw != (VIEW_SIZE, VIEW_SIZE) for hw in renders):
        raise AssertionError(f"viewer_train: frames at {renders}")
    want = {"F32-ENC": F32_PER_STEP * VIEWER_TRAIN_STEPS + F32_PER_FRAME * len(renders),
            "F32-ENC-BWD": F32_PER_STEP * VIEWER_TRAIN_STEPS, "Q-ENC": 0}
    if launches != want:
        raise AssertionError(f"viewer_train launched {launches}, not {want}")
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
    cull, fused_model = cull_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        viewer = viewer_phase(dev, fused_model, Path(tmp))
    del fused_model
    serve_bf16 = serve_bf16_phase(dev)
    train = train_phase(dev)
    train_reference = train_reference_phase(dev)
    evaluation = eval_phase(dev)
    attn_rows = attn_kernel_phase(dev)
    attn_bf16_rows = attn_bf16_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        checkpoint = root / "sam_vit_h_seeded.pth"
        vit_h_checkpoint(dev, checkpoint)
        frames = _scene_images(write_scene(root / "frames", num_train=ENCODE_IMAGES,
                                           num_test=0, h=512, w=512))
        encode = encode_phase(dev, checkpoint, frames)
        amg = amg_phase(dev, checkpoint, frames)
        encode_reference = encode_reference_phase(dev)
        encode_bf16 = encode_bf16_phase(dev, checkpoint, frames)
        preprocess = preprocess_phase(dev, checkpoint, root)
        clip_paths = clipseg_checkpoint(dev, root)
        clipseg = clipseg_phase(dev, clip_paths, frames)
        preprocess_clipseg = preprocess_clipseg_phase(dev, clip_paths, root / "scene", root)
        text_view = view_phase(dev, clipseg=clip_paths)
        no_distill_view = no_distill_view_phase(dev, checkpoint, clip_paths)
        no_distill_train = no_distill_train_phase(dev, root / "scene", root)
        train_bf16 = train_bf16_phase(dev, root)
        viewer_train = viewer_train_phase(dev, root / "scene_bf16", root, train["step_ms"])

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
                                             "train": train["launches"][name],
                                             "eval": evaluation["launches"][name],
                                             "view_no_distill": sum(
                                                 r["launches"][name]
                                                 for r in no_distill_view["views"]),
                                             "train_no_distill":
                                                 no_distill_train["launches"].get(name, 0)},
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                        "library_ms": None,
                        "ms_frame_positions": next(
                            r["ms"] for r in mine if r["shape"] == "nerfacto"
                            and r["positions"] == "frame" and r["variant"] in ("f32", "q8"))})
    for k in kernels:
        k["launches_by_path"].update(serve_int8_fused=serve["int8_fused"]["launches"][k["name"]])
    kernels[0]["launches_by_path"].update(cull_bake_f32=cull["bake"]["f32"]["launches"]["F32-ENC"],
                                          viewer_train=viewer_train["launches"]["F32-ENC"])
    kernels[1]["launches_by_path"].update(
        cull_bake_int8=cull["bake"]["int8_fused"]["launches"]["Q-ENC"])
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
                        "view": view["launches"], "view_text": text_view["launches"],
                        "cull": sum(r["launches"]["FUSED-QMLP"] for r in cull["runs"].values()),
                        "viewer": viewer["launches"]["FUSED-QMLP"]},
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
                    "launches_by_path": {
                        "train": train["launches"]["F32-ENC-BWD"],
                        "train_eval": evaluation["run_launches"]["F32-ENC-BWD"],
                        "train_no_distill": no_distill_train["launches"]["F32-ENC-BWD"],
                        "viewer_train": viewer_train["launches"]["F32-ENC-BWD"]},
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
                    "launches_by_path": {"encode": encode["launches"], "amg": amg["launches"],
                                         "preprocess": preprocess["launches"],
                                         "view_no_distill": no_distill_view["launches"]},
                    "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep["library_ms"]})
    # the bf16 routes: the wgmma kernel on the main path (ViT-H's global
    # layers, its row), the mma.sync kernel on every other shape (the
    # small encoder's 16-wide grid, the ragged row)
    for name, shape, launches, by_path in (
            ("FLASH-RELPOS-BF16-WGMMA", "vit_h", encode_bf16["launches_wgmma"],
             {"encode_bf16": encode_bf16["launches_wgmma"]}),
            ("FLASH-RELPOS-BF16", "ragged", encode_reference["bf16_launches"],
             {"encode_reference_bf16": encode_reference["bf16_launches"],
              "encode_bf16": encode_bf16["launches"] - encode_bf16["launches_wgmma"]})):
        mine = [r for r in attn_bf16_rows if r["kernel"] == name]
        rep = next(r for r in mine if r["shape"] == shape)
        kernels.append({"name": name, "route": "cuda",
                        "source": "samnerf_tpu_torch/csrc/attention_relpos.cu",
                        "replaces": "samnerf_tpu/ops/attention_pallas.py:32",
                        "launches": launches, "launches_by_path": by_path,
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
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
         "preprocess": preprocess, "clipseg": clipseg,
         "preprocess_clipseg": preprocess_clipseg, "text_view": text_view,
         "no_distill_view": no_distill_view, "no_distill_train": no_distill_train,
         "serve_bf16": serve_bf16, "attn_bf16_kernel_rows": attn_bf16_rows,
         "encode_bf16": encode_bf16, "train_bf16": train_bf16,
         "eval": evaluation, "amg": amg, "cull": cull, "viewer": viewer,
         "viewer_train": viewer_train, "kernels": kernels}, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
