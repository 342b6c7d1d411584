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
5. train_kernels: the encode backward F32-ENC-BWD against its plain
   version, and F32-ENC, at the three encode shapes of a
   ``samnerf_distill`` training step (16384 rays), at uniform positions
   and at the positions and cotangents of one full-width ``Trainer`` step
   (captured by ``profile_train.capture_step_encodes``), and
   F32-ENC-BWD's layout pass GRAD-DEINTERLEAVE against its plain version;
6. serve: full-width ``samnerf_distill`` 512x512 frames through
   ``SamNerfRenderer.serve_frame_fn`` (static preset) with f32 tables,
   baked int8 tables, and baked int8 tables served through FUSED-QMLP
   (``serve_fuse_mlp``), each frame one CUDA graph replay: the first
   frame's eager run and capture launch twice a frame's kernels, and a
   replay runs on the card, counted by name in a profiler trace, 22 F32-ENC
   per f32 frame and 19 FUSED-QMLP per fused frame; dispatch_serve: those
   frames and the fused int8 one culled by a ball grid, replayed against
   ``serve.eager`` (the same frame one launch per op) on six cameras and
   clicks, bit for bit, no launch from Python in a replay and on the card
   the eager frame's kernels, wall, device span, busy and idle of both;
   then a 64x64 frame of a
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
   ``scripts/render.py --traj filename``; each JPEG bit for bit the
   JPEG of the ``render_view`` output it shows, message -> image ms per
   render state;
   serve_bf16: the same model with ``compute_dtype=torch.bfloat16``:
   512x512 frames with f32 tables, baked int8, and baked int8 with
   ``serve_fuse_mlp`` (Q-ENC and the unfused bf16 MLPs: FUSED-QMLP
   computes in f32 only), ``render_view`` with one click, and a small bf16
   model's grids on the card against the CPU;
7. train: full-width ``samnerf_distill`` training steps on a synthetic
   512x512 scene through the port's ``Trainer`` with ``steps_per_dispatch``
   1, the eager step (ms per step, rays/s,
   peak memory, launches per step: 6 F32-ENC and 6 F32-ENC-BWD, and the
   layout passes, counted apart; losses); dispatch_train: the preset's
   blocks of 20 steps, one CUDA graph replay each, against 40 eager steps
   from one state (step counts, parameters, Adam moments and losses within
   the eager path's own run-to-run spread), the eager step's launches
   against the replay's kernels on the card per step, wall, device span,
   busy and idle per step of both; then one train step of a
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
8. dino: a seeded ``dino_vits8.pth`` (reference layout); ViT-S/8
   descriptors (stride 4, layer 11 ``key``) of the train phase's
   synthetic 512x512 scene through ``ViTExtractor`` (ms per image and
   peak memory at 1024 to 8192 query rows per attention product and with
   the whole attention) and
   ``get_dino_embeddings.main``; a small image card vs CPU; 100 full-width
   ``samnerf_distill`` steps with ``--model.use-dino-feature True
   --datamanager.use-dino-feature True`` in the preset's blocks, the first
   captured (step ms of the replays, the DINO loss falling, 6 + 6 a step
   on the card);
   data: every dataparser family's scene, its rays card vs CPU; the
   scene as a Blender and an instant-ngp directory routed by
   ``_detect_parser`` and trained at full width; the scene with an OpenCV
   distortion (rays card vs CPU, trained, rendered along fisheye and
   equirectangular camera paths by ``scripts/render.py``); a model with
   appearance embeddings trained and served as baked int8 512x512
   frames, fused (19 FUSED-QMLP) and not (22 Q-ENC);
   zoo: each of the eight zoo methods through ``train.main`` at its
   default widths on that scene (4096 rays a step; instant-ngp with its
   occupancy grid updated twice): ms per step, rays/s, peak memory, the
   losses and the eval PSNR of view 0, F32-ENC / F32-ENC-BWD launches per
   step and per eval image for the hash methods, and both f32 kernels held
   against their plain versions at an instant-ngp step's positions;
   zoo_reference: one small instant-ngp step on the card against the CPU
   (the grid bit for bit, the losses, every gradient, the eval outputs);
   quality: the textured scene of the mIoU study (24 + 4 views of
   256x256, detail 4; its digests against the JAX package's), ViT-B
   targets through ``quality_distill_miou.make_vit_features`` (ms per
   image, 4 FLASH-RELPOS launches per image, the first embedding against
   the plain-attention route), ``quality_capacity.train_and_eval`` at
   2^19 / 2^17 with the morton hash and 16384 rays for 300 of the study's
   3000 steps (step ms, rays/s, 6 + 6 launches a step, test PSNR, SSIM,
   SAM-feature MSE and cosine), ``view_miou`` on one held-out view at a
   16x16 prompt grid, and instant-ngp through ``validate_zoo.run_method``
   for 200 steps at 128x128 with its margin over ``trivial_psnr``, and
   depth-nerfacto the same way on ``validate_zoo --views 64``'s scene for
   2000 steps at seed 3, which must clear the constant colour by 3 dB
   with 2 + 2 f32 launches a step, its proposal MLP's dead units beside;
9. export: ``scripts/exporter.py``'s ``main`` on the eval phase's run
   directory in each mode at the exporter's defaults (8 views of
   256x256, TSDF and Poisson at 128^3): ms, points / vertices / faces,
   peak memory, F32-ENC launches per view against the renderer's
   chunking; TSDF integration and the Poisson indicator (200 CG steps) of
   two rendered views on the card against the CPU;
   pose: ``generate_rays`` with SO3xR3 and SE3 ``CameraOptimizer`` deltas
   for a 16384-ray batch, card against CPU; the SE3 gradient at zero
   finite; a small model's pose gradient (F32-ENC, F32-ENC-BWD) card
   against CPU;
   dist: a one-rank NCCL process group at a free local port: full-width
   data-parallel ``Trainer`` steps (ms beside the train phase's, 6 + 6
   launches per step, the gradient all-reduce's ms) and
   ``build_sharded_frame_fn`` at 512x512 with baked int8 fused tables and
   a click (19 FUSED-QMLP launches per frame, the frame against
   ``serve_frame_fn``'s); then ``torchrun --standalone --nproc-per-node 1
   -m samnerf_tpu_torch.train samnerf_distill`` for 3 steps;
   tools: the SAM decoder through ``torch.export`` (ms per call against
   ``decode_masks``, the masks held against it), ``scripts/benchmark.py``
   over two copies of a synthetic scene, one ``DeviceTrace``, the SDS
   DDIM loop and gradient card against CPU, and the native image decoder
   (built or PIL) against PIL's bytes, with the native build's error when
   it did not build;
10. attn_kernel: FLASH-RELPOS against its plain version at SAM ViT-H's
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
11. encode: SAM ViT-H at full width (seeded weights, saved once as a
   reference-layout checkpoint and loaded through ``build_sam``) through
   ``SamPredictor.set_image`` on 512x512 frames (ms per image, peak
   memory, FLASH-RELPOS launches per image, click -> mask ms), and the
   kernel route's embedding against the plain route's;
   amg: ``SamAutomaticMaskGenerator`` over the same ViT-H on a 512x512
   frame with the JAX package's defaults, then with the IoU and stability
   filters off and one crop layer (5 crops: ms per ``generate``, masks,
   peak memory, 4 FLASH-RELPOS launches per ``set_image``), and a small
   SAM's ``generate`` on the card against the CPU;
   encode_reference: a small encoder on the card against the same encoder
   on the CPU, in f32 and in bf16 (its 16-wide grid takes the
   ``mma.sync`` bf16 kernel);
   encode_bf16: ``build_sam_vit_h(checkpoint,
   compute_dtype=torch.bfloat16)`` through ``set_image`` (ms per image,
   peak memory, 4 bf16 FLASH-RELPOS launches per image, all by the wgmma
   kernel, the embedding's error against the f32 encode, the kernel route
   against the plain version in its place);
12. preprocess: ``python -m samnerf_tpu_torch.preprocessing
   .get_image_embeddings`` (its ``main``) with that checkpoint on a
   synthetic 24-image 512x512 scene, the port's feature loader on the
   files, and 3 ``Trainer`` steps on them;
13. clipseg_checkpoint: seeded CLIP ViT-B/16 and ``rd64-uni`` weights in
   the reference layouts and a small merges file, in the same temporary
   directory; clipseg: ``ClipSegPredictor`` at full width on the card
   (ms per ``encode_text`` of 3 prompts, ``segment``,
   ``reduced_activations``, ``decode_rendered``; peak memory) and against
   the CPU on one frame;
14. preprocess_clipseg: ``python -m samnerf_tpu_torch.preprocessing
   .get_clipseg_embeddings`` (its ``main``) on the same scene, the
   feature loader on its files, and 3 ``samnerf_distill`` steps on the
   SAM and ClipSeg targets the port wrote;
15. text_view: the view phase with a ``ClipSegPredictor`` and a text
   prompt in every view (``clipseg_feature`` in [0, 1], the heatmap's
   points reach the mask decode after the pins);
16. no_distill_view: ``render_view`` of the ``samnerf_no_distill``
   preset's model at full width with a ``LanguageSAM`` (the ViT-H
   checkpoint and the seeded ClipSeg): a click view, three moved views
   with the click locked, a text-prompt view; 4 FLASH-RELPOS launches per
   view, the locked point in every mask decode;
17. no_distill_train: 10 full-width ``samnerf_no_distill`` steps through
   ``Trainer`` on the scene; train_bf16: ``samnerf_distill
   --model.compute-dtype bfloat16`` through the train entry at full width
   on the train phase's synthetic scene in the preset's blocks, the first
   captured, then two replays (ms per step, rays/s, peak memory, 6 F32-ENC
   and 6 F32-ENC-BWD per step on the card);
   viewer_train: the train entry with ``--vis viewer`` on free ports, 60
   full-width steps on that scene in three blocks (one captured, two
   replayed with the viewer live), a client that gets frames while it
   trains (step ms beside the train phase's; 6 + 6 launches a step Python
   ran and 22 F32-ENC a 512x512 viewer frame, 6 + 6 a replayed step on
   the card);
18. one ``{"kernels": [...]}`` line (the f32 kernels' layout passes
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
import copy
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import math
import re
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
BF16_TRAIN_STEPS = 40           # timed, in blocks of 20, after one block
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


HASH_KERNELS = ("F32-ENC", "Q-ENC", "FUSED-QMLP", "F32-ENC-BWD", "BF16-PACK",
                "GRAD-DEINTERLEAVE")


def _reset_encode_launches():
    from samnerf_tpu_torch.ops import kernel_launches
    kernel_launches.reset(HASH_KERNELS)


def _encode_launches():
    from samnerf_tpu_torch.ops import kernel_launches
    return kernel_launches.counts(("F32-ENC", "Q-ENC", "FUSED-QMLP"))


def _pass_launches():
    """Launches of the f32 kernels' layout passes, counted apart."""
    from samnerf_tpu_torch.ops import kernel_launches
    return kernel_launches.counts(("BF16-PACK", "GRAD-DEINTERLEAVE"))


def _trace_launches(names):
    """The hash kernels and layout passes among a trace's device kernel names."""
    from samnerf_tpu_torch.ops import kernel_launches
    return kernel_launches.trace_counts(names, HASH_KERNELS)


class _CardTrace:
    """The hash kernels and layout passes that ran on the card between
    ``start()`` and ``stop()``, by name, from a profiler trace: CUDA graph
    replays included, which the wrappers' counters do not see (they count
    what Python launches, a capture once).  Also a context manager.
    The profiler has lost device records once (a trace of 80 replayed
    DINO steps, about 70,000 records, came back 4 F32-ENC-BWD short; the
    cause is not known), so a trace spans at most one block of replayed
    steps or a few frames, and ends with a few no-op kernels after the
    work it counts; ``records`` is the number of device records it
    kept."""

    def __init__(self):
        self._prof = None
        self.counts = None
        self.records = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        return self

    def stop(self) -> dict:
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        pad = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(4):
            pad.add_(1)
        torch.cuda.synchronize()
        self._prof.stop()
        names = [e.name() for e in self._prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        self.counts = _trace_launches(names)
        self.records = len(names)
        self._prof = None
        return self.counts

    @property
    def running(self) -> bool:
        return self._prof is not None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


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
        _reset_encode_launches()
        serve(_cameras(dev, 0, H, W, 400.0), 0, clicks[0])        # eager frame, capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i, click in enumerate(clicks[1:], start=1):
            t0 = time.perf_counter()
            img = serve(_cameras(dev, i, H, W, 400.0), 0, click)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
                raise AssertionError(f"frame {img.dtype} {tuple(img.shape)}")
        frames = len(times)
        launches = _encode_launches()       # the first frame's eager run and capture
        passes = _pass_launches()
        with _CardTrace() as trace:         # one more replay
            serve(_cameras(dev, 1, H, W, 400.0), 0, clicks[1])
        results[tag] = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                            frames=frames, launches=launches, pass_launches=passes,
                            replay_on_card=trace.counts,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"serve {tag:10s} 512x512 static: median frame "
              f"{results[tag]['frame_ms']:.2f} ms over {frames} replayed frames "
              f"({', '.join(f'{t:.1f}' for t in times)}); launches of the eager first "
              f"frame and its capture "
              + " ".join(f"{k}={v:g}" for k, v in {**launches, **passes}.items())
              + "; on the card in a replay "
              + " ".join(f"{k}={v:g}" for k, v in trace.counts.items() if v)
              + f"; max_memory_allocated="
              f"{results[tag]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del model, snr, serve
    expect = {"f32": {"F32-ENC", "BF16-PACK"}, "int8": {"Q-ENC"},
              "int8_fused": {"FUSED-QMLP"}}
    for tag, kernels in expect.items():
        r = results[tag]
        ran = {k for k, v in {**r["launches"], **r["pass_launches"]}.items() if v}
        on_card = {k for k, v in r["replay_on_card"].items() if v}
        if ran != kernels or on_card != kernels:
            raise AssertionError(f"the {tag} serve path launched {ran}, and its replay "
                                 f"ran {on_card} on the card, not {kernels}")
    for tag, kernel, per_frame in (("int8_fused", "FUSED-QMLP", FUSED_PER_FRAME),
                                   ("f32", "F32-ENC", F32_PER_FRAME)):
        r = results[tag]
        if r["launches"][kernel] != 2 * per_frame or r["replay_on_card"][kernel] != per_frame:
            raise AssertionError(f"{kernel}: {r['launches'][kernel]} launches in the eager "
                                 f"frame and the capture, {r['replay_on_card'][kernel]} on "
                                 f"the card in a replay, not {per_frame} a frame")
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
        _reset_encode_launches()
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
        launches = _encode_launches()
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
        _reset_encode_launches()
        decoded.clear()
        t0 = time.perf_counter()
        out = snr.render_view(cams, 0, intrin, c2w, points=points, text_prompt=text, **crop)
        ms = (time.perf_counter() - t0) * 1e3
        launches = _encode_launches()
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
        # the eager step, one launch per op, as before blocks of steps
        # (the dispatch_train phase runs those)
        trainer = build_synthetic_trainer(Path(tmp), dev, steps_per_dispatch=1)
        losses, times, t_prev = [], [], [0.0]

        def on_step(step, metrics):
            # counts, peak memory and step times cover the steps after warm-up
            losses.append({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            now = time.perf_counter()
            if step == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
                _reset_encode_launches()
            elif step > TRAIN_WARMUP:
                times.append((now - t_prev[0]) * 1e3)
            t_prev[0] = now

        trainer.cfg.max_num_iterations = TRAIN_WARMUP + TRAIN_STEPS
        trainer.train(step_callback=on_step)
        launches = {"F32-ENC": hg.parity_hash_encode.launches,
                    "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                    "Q-ENC": hg.parity_hash_encode_q8.launches}
        passes = _pass_launches()
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


DISPATCH_BLOCK = 20             # the presets' steps_per_dispatch
DISPATCH_REPS = 3               # timed blocks or frames of each path, after a warm-up
# a block's replay against the eager steps: F32-ENC-BWD sums table
# gradients with f32 atomics in a run-to-run order, so two eager runs from
# one state already differ; the graph must stay within DISPATCH_SPREAD times
# that spread of the eager run (relative L2 of each parameter and moment,
# the worst), or within DISPATCH_FLOOR (the capturable update's f32
# rounding, engine/optimizers.py), and its losses within TOL_LOSS
DISPATCH_SPREAD = 4.0
DISPATCH_FLOOR = 1e-6


def _wall_busy(fn, per: int, reps: int = DISPATCH_REPS) -> dict:
    """``fn()`` runs ``per`` steps or frames.  After a warm-up call: the
    median host wall of ``reps`` synchronised calls, the device span of
    one (CUDA events on the current stream), and one under the profiler:
    device busy (the sum of its kernels: one stream, so they do not
    overlap), kernels, the hash kernels and layout passes among them by
    name, and idle share (1 - busy / wall), each per step or frame.  A
    profile that shows no kernel leaves busy unmeasured (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / per)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / per if kernels else None
    wall = statistics.median(times)
    on_card = _trace_launches(e.name for e in kernels)
    return dict(wall_ms=wall, wall_ms_all=times, device_span_ms=a.elapsed_time(b) / per,
                busy_ms=busy, kernels=len(kernels) / per,
                on_card={k: v / per for k, v in on_card.items()},
                idle_share=None if busy is None else 1.0 - busy / wall)


def _fmt_timing(t: dict) -> str:
    busy = "not measured" if t["busy_ms"] is None else (
        f"{t['busy_ms']:.2f} ms busy ({t['kernels']:g} kernels), idle {t['idle_share']:.3f}")
    return (f"wall {t['wall_ms']:.2f} ms ({', '.join(f'{v:.2f}' for v in t['wall_ms_all'])}), "
            f"device span {t['device_span_ms']:.2f} ms, {busy}")


def _train_snapshot(trainer):
    return (copy.deepcopy(trainer.model.state_dict()),
            copy.deepcopy(trainer.optimizer.state_dict()),
            dataclasses.replace(trainer.state), trainer.generator.get_state())


def _train_restore(trainer, snap):
    model, opt, state, gen = snap
    trainer.model.load_state_dict(model)
    trainer.optimizer.load_state_dict(copy.deepcopy(opt))
    trainer.state = dataclasses.replace(state)
    trainer.generator.set_state(gen)


def _rel_l2(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _train_distance(a, b) -> dict:
    """Worst relative L2 distance of the parameters and of the Adam moments
    of two trainers; raises unless their step counts agree."""
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["count"] != sb["count"] or a.state != b.state:
        raise AssertionError(f"step counts differ: {sa['count']} {a.state} against "
                             f"{sb['count']} {b.state}")
    moments = 0.0
    for name, s in sa["optimizer"]["state"].items():
        t = sb["optimizer"]["state"][name]
        if float(s["step"]) != float(t["step"]):
            raise AssertionError(f"Adam steps of {name} differ: {s['step']} {t['step']}")
        moments = max(moments, _rel_l2(s["exp_avg"], t["exp_avg"]),
                      _rel_l2(s["exp_avg_sq"], t["exp_avg_sq"]))
    params = max(_rel_l2(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    return dict(params=params, moments=moments)


def dispatch_train_phase(dev):
    """``steps_per_dispatch`` at full width: the ``samnerf_distill``
    trainer (its preset's 20 steps a dispatch) on the train phase's
    synthetic scene runs one block eagerly and captures it; from that
    state and generator, two eager runs of 40 steps (``steps_per_dispatch``
    1, ``torch.optim.Adam``) and two replays of the block give the same
    step counts, and parameters, Adam moments and losses within
    ``DISPATCH_SPREAD`` times the two eager runs' spread (or
    ``DISPATCH_FLOOR``) and ``TOL_LOSS``; the replays launch nothing from
    Python, and on the card (a profiler trace of the second, by kernel
    name) a replay runs per step the kernels and layout passes the eager
    step launches; wall,
    device span, busy and idle per step of both paths, and their peak
    memory."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts.profile_train import build_trainer
    from samnerf_tpu_torch.utils.synthetic import write_scene

    n = DISPATCH_BLOCK
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scene = write_scene(root / "scene", num_train=24, num_test=2, h=512, w=512,
                            with_features=True, feature_long_side=64)
        graphed = build_trainer(scene, root / "g", dev)
        if graphed.block != n:
            raise AssertionError(f"the preset dispatches {graphed.block} steps, not {n}")
        graphed.run_block(n)                                # eager, then captured
        if graphed._graph is None:
            raise AssertionError("the first block was not captured")
        snap = _train_snapshot(graphed)
        eager = []
        for k in range(2):
            tr = build_trainer(scene, root / f"e{k}", dev, steps_per_dispatch=1)
            _train_restore(tr, snap)
            _reset_encode_launches()
            losses = [float(tr.train_iteration(n + i)["total_loss"]) for i in range(2 * n)]
            eager.append((tr, losses, {**_encode_launches(), **_pass_launches(),
                                       "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches}))
        graph = graphed._graph
        _reset_encode_launches()
        graph_losses = [float(graphed.run_block(n)["total_loss"])]
        with _CardTrace() as trace:                 # the second (see _CardTrace)
            graph_losses.append(float(graphed.run_block(n)["total_loss"]))
        python = {**_encode_launches(), **_pass_launches(),
                  "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches}
        if graphed._graph is not graph \
                or graphed.steps_by_dispatch != {"eager": n, "captured": n, "replayed": 2 * n}:
            raise AssertionError(f"a block was captured again, not replayed: "
                                 f"{graphed.steps_by_dispatch}")
        (e0, l0, eager_launches), (e1, _, _) = eager
        spread = _train_distance(e1, e0)
        gap = _train_distance(graphed, e0)
        loss_err = max(abs(g - e) / abs(e) for g, e in zip(graph_losses, (l0[n - 1], l0[-1])))
        report = dict(block=n, spread=spread, gap=gap, graph_losses=graph_losses,
                      eager_losses=[l0[n - 1], l0[-1]], loss_max_rel_err=loss_err,
                      replay_on_card=trace.counts, trace_records=trace.records,
                      replays_python_launches=python, eager_launches=eager_launches,
                      on_card_per_step={k: v / n for k, v in trace.counts.items()})
        print(f"dispatch_train: blocks of {n} steps, 2 replays against {2 * n} eager steps "
              f"from one state: params rel L2 {gap['params']:.3e}, moments "
              f"{gap['moments']:.3e} (two eager runs: {spread['params']:.3e}, "
              f"{spread['moments']:.3e}); losses {graph_losses} against "
              f"{report['eager_losses']} (max rel err {loss_err:.2e}); on the card a step "
              + " ".join(f"{k}={v:g}" for k, v in report["on_card_per_step"].items())
              + "; launched from Python by the replays "
              + " ".join(f"{k}={v}" for k, v in python.items()), flush=True)
        worst = max(spread.values())
        if max(gap.values()) > max(DISPATCH_SPREAD * worst, DISPATCH_FLOOR) \
                or loss_err > TOL_LOSS:
            raise AssertionError(f"a block replay is not its eager steps: {report}")
        if any(python.values()) or {k: 2 * trace.counts[k] for k in eager_launches} \
                != eager_launches or eager_launches["F32-ENC"] != F32_PER_STEP * 2 * n \
                or eager_launches["F32-ENC-BWD"] != F32_PER_STEP * 2 * n:
            raise AssertionError(f"the second replay ran {trace.counts} on the card "
                                 f"({trace.records} device records), the replays launched "
                                 f"{python}, the {2 * n} eager steps {eager_launches}")
        del e1, eager
        torch.cuda.synchronize()
        for name, fn, tr in (("eager", lambda: [e0.train_iteration(0) for _ in range(n)], e0),
                             ("graph", lambda: graphed.run_block(n), graphed)):
            torch.cuda.reset_peak_memory_stats()
            t = _wall_busy(fn, n)
            t.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                     memory_reserved=torch.cuda.memory_reserved())
            report[name] = t
            print(f"dispatch_train {name}: per step " + _fmt_timing(t)
                  + f"; max_memory_allocated {t['max_memory_allocated'] / 2**30:.2f} GiB, "
                  f"reserved {t['memory_reserved'] / 2**30:.2f} GiB", flush=True)
        if report["eager"]["on_card"] != report["graph"]["on_card"]:
            raise AssertionError(f"by kernel name an eager step ran "
                                 f"{report['eager']['on_card']}, a replayed one "
                                 f"{report['graph']['on_card']}")
        del e0, graphed
    return report


def dispatch_serve_phase(dev):
    """``serve_frame_fn`` as one graph replay a frame at full width (the
    serve phase's seeded ``samnerf_distill`` model, 512x512, static preset)
    with f32, baked int8 and fused int8 tables, and fused int8 culled by
    the ball grid: on the six cameras and clicks each replayed frame's
    uint8 image and mask equal the eager frame's (``serve.eager``) bit for
    bit, and the replays launch nothing from Python; one graph per route;
    wall, device span, busy and idle per frame of both, the hash kernels
    each runs on the card by name (a profiler trace: the replay's must be
    the eager frame's launches), and peak memory."""
    from samnerf_tpu_torch.engine.eval_render import occupancy_from_cells
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    H = W = 512
    cfg = SAMModelConfig(hash_fn="morton")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    clicks = [(256.0, 256.0), (100.0, 300.0), (400.0, 120.0), (320.0, 420.0),
              (60.0, 60.0), (480.0, 300.0)]
    ball = occupancy_from_cells(_ball_cells(), 0.5, device=dev)[0]
    results = {}
    for tag, q8, fuse, occ in (*((t, q, f, None) for t, q, f in SERVE_RUNS),
                               ("culled", True, True, ball)):
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        snr.occ = occ
        serve = snr.serve_frame_fn(sam, H, W)
        serve(_cameras(dev, 0, H, W, 400.0), 0, clicks[0])     # eager frame, capture
        launches = {}
        for i, click in enumerate(clicks):
            cams = _cameras(dev, i, H, W, 400.0)
            outs = {}
            for path, fn in (("eager", serve.eager), ("graph", serve)):
                _reset_encode_launches()
                outs[path] = fn(cams, 0, click, return_mask=True)
                launches[path] = {**_encode_launches(), **_pass_launches()}
            same = all(torch.equal(a, b) for a, b in zip(outs["eager"], outs["graph"]))
            if not same or any(launches["graph"].values()):
                raise AssertionError(f"{tag} frame {i}: the replay differs from the eager "
                                     f"frame (same bits: {same}; launches {launches})")
        if len(serve.graphs) != 1:
            raise AssertionError(f"{tag}: {len(serve.graphs)} graphs for one key")
        report = dict(frames_bit_for_bit=len(clicks), eager_launches=launches["eager"])
        cams = _cameras(dev, 1, H, W, 400.0)
        for path, fn in (("eager", serve.eager), ("graph", serve)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = _wall_busy(lambda: fn(cams, 0, clicks[1]), 1)
            t.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
                     memory_reserved=torch.cuda.memory_reserved())
            report[path] = t
            print(f"dispatch_serve {tag:10s} {path}: per frame " + _fmt_timing(t)
                  + f"; max_memory_allocated {t['max_memory_allocated'] / 2**30:.2f} GiB, "
                  f"reserved {t['memory_reserved'] / 2**30:.2f} GiB", flush=True)
        on_card = {k: report["graph"]["on_card"][k] for k in launches["eager"]}
        report["launches_per_frame"] = on_card
        print(f"dispatch_serve {tag}: {len(clicks)} replayed frames equal the eager frames "
              f"bit for bit (image and mask); on the card a replay runs "
              + " ".join(f"{k}={v:g}" for k, v in on_card.items())
              + ", the eager frame launches "
              + " ".join(f"{k}={v}" for k, v in launches["eager"].items()), flush=True)
        if on_card != launches["eager"] \
                or report["eager"]["on_card"] != report["graph"]["on_card"]:
            raise AssertionError(f"{tag}: a replay ran {report['graph']['on_card']} on the "
                                 f"card, the eager frame {report['eager']['on_card']} and "
                                 f"launched {launches['eager']}")
        results[tag] = report
        del model, snr, serve
    return results


def train_bf16_phase(dev, root: Path):
    """``samnerf_distill`` with ``--model.compute-dtype bfloat16`` through
    the port's train entry (``train.parse``, ``train.train_loop``) at full
    width on the train phase's synthetic scene, in the preset's blocks of
    20 steps (the first captured, then ``BF16_TRAIN_STEPS`` in replays and
    one more replayed block under a trace):
    ms per step of the replays, rays/s, peak memory, finite losses, and 6
    F32-ENC and 6 F32-ENC-BWD per step on the card (the hash encodes stay
    f32; their cotangents arrive in f32)."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.utils.synthetic import write_scene

    scene = write_scene(root / "scene_bf16", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    config = train_entry.parse([
        "samnerf_distill", "--data", str(scene), "--model.compute-dtype", "bfloat16",
        "--vis", "none",
        "--trainer.save-final", "false", "--trainer.output-dir", str(root / "out_bf16")])
    if config.model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"the CLI gave compute_dtype {config.model.compute_dtype}")
    trainer, losses, times, launches, counted, peak = _timed_train(
        config, dev, "the bf16 train path", steps=BF16_TRAIN_STEPS)
    if trainer.model.fields.mlp_base.compute_dtype != torch.bfloat16:
        raise AssertionError("the trained model is not bf16")
    rays = trainer.datamanager.config.train_num_rays_per_batch
    del trainer
    step_ms = statistics.median(times)
    result = dict(step_ms=step_ms, step_ms_all=times, rays_per_s=rays / step_ms * 1e3,
                  steps=BF16_TRAIN_STEPS, launches=launches, traced_steps=counted,
                  launches_per_step={k: v / counted for k, v in launches.items()},
                  max_memory_allocated=peak, first_losses=losses[0], last_losses=losses[-1])
    print(f"train_bf16 samnerf_distill --model.compute-dtype bfloat16, {rays} rays/step: "
          f"median step {step_ms:.2f} ms over {len(times)} replays of "
          f"{DISPATCH_BLOCK} steps ({', '.join(f'{t:.2f}' for t in times)}), "
          f"{result['rays_per_s']:,.0f} rays/s; on the card a step "
          + ", ".join(f"{k}={v:g}" for k, v in result["launches_per_step"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB; losses after the first block "
          f"{losses[0]}, the last {losses[-1]}", flush=True)
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
        _reset_encode_launches()
        serve(_cameras(dev, 0, H, W, focal), 0, clicks[0])        # eager frame, capture
        python = _encode_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i, click in enumerate(clicks[1:BF16_FRAMES + 1], start=1):
            t0 = time.perf_counter()
            img = serve(_cameras(dev, i, H, W, focal), 0, click)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
                raise AssertionError(f"bf16 frame {img.dtype} {tuple(img.shape)}")
        with _CardTrace() as trace:                 # one more replay
            serve(_cameras(dev, 1, H, W, focal), 0, clicks[1])
        launches = {k: trace.counts[k] for k in python}
        results[tag] = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                            launches=launches, python_launches=python,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"serve_bf16 {tag:13s} 512x512 static: median frame "
              f"{results[tag]['frame_ms']:.2f} ms over {len(times)} replayed frames "
              f"({', '.join(f'{t:.1f}' for t in times)}); on the card a replay "
              + " ".join(f"{k}={v:g}" for k, v in launches.items())
              + f"; launched by the eager first frame and its capture {python}"
              + f"; max_memory_allocated="
              f"{results[tag]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        ran = {k for k, v in launches.items() if v}
        if ran != kernels or python != {k: 2 * v for k, v in launches.items()}:
            raise AssertionError(f"the bf16 {tag} serve path ran {launches} on the card "
                                 f"in a replay and launched {python}")
        del serve
        if fuse:
            intrin = VIEW_INTRIN * (size / VIEW_SIZE)
            intrin[2, 2] = 1.0
            c2w = look_at_c2w(np.array([1.2 * np.cos(0.3), 1.2 * np.sin(0.3), 0.45]),
                              np.zeros(3))
            cams = cameras_from_intrin_c2w(intrin, c2w, H, W, device=dev)
            _reset_encode_launches()
            t0 = time.perf_counter()
            out = snr.render_view(cams, 0, intrin, c2w,
                                  points=np.array([[0.45 * size, 0.55 * size]]))
            view_ms = (time.perf_counter() - t0) * 1e3
            for k in ("rgb", "depth", "masked_rgb"):
                if out[k].shape[:2] != (H, W) or not np.isfinite(out[k]).all():
                    raise AssertionError(f"bf16 view {k}: {out[k].shape} or not finite")
            results["view"] = dict(ms=view_ms, launches=_encode_launches(),
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
        _reset_encode_launches()
        decoded.clear()
        t0 = time.perf_counter()
        out = snr.render_view(cams, 0, intrin, c2w, points=click, text_prompt=text)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_encode_launches(), **{"FLASH-RELPOS": ta.flash_attention_relpos.launches})
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
            _reset_encode_launches()
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


def eval_phase(dev, size: int = 512, root: Path = None):
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
    metrics on the card against the CPU.  With ``root``, the scene and the
    run directory (``run_dir`` in the result) are written there and kept."""
    import os

    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR, Trainer
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts import eval as eval_script
    from samnerf_tpu_torch.utils import metrics, writer
    from samnerf_tpu_torch.utils.eval_utils import find_latest_checkpoint
    from samnerf_tpu_torch.utils.synthetic import write_scene

    with (contextlib.nullcontext(str(root)) if root is not None
          else tempfile.TemporaryDirectory()) as tmp:
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
        _reset_encode_launches()
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
        _reset_encode_launches()
        times, per = [], []
        for i in range(EVAL_IMAGES):
            t0 = time.perf_counter()
            m, images = pipe.get_eval_image_metrics_and_images(i % 2)
            times.append((time.perf_counter() - t0) * 1e3)
            per.append(m)
        image_launches = _encode_launches()
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
                  checkpoint_bits_equal=bits, reference=reference, run_dir=str(run))
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
            _reset_encode_launches()
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
VIEWER_JPEG_QUALITY = 70        # the render thread's JPEGs
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
            _reset_encode_launches()
            t0 = time.perf_counter()
            frac = snr.bake_occupancy(res=CULL_RES, sub=2)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = _encode_launches()
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
            # the counts are read back in the frame, which a graph cannot hold
            img = serve.eager(cams, 0, click)
        if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
            raise AssertionError(f"culled frame {img.dtype} {tuple(img.shape)}")
        _reset_encode_launches()
        serve(cams, 0, click)                       # an eager frame, then its capture
        launches = _encode_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, times = _serve_ms(serve, cams, click)
        with _CardTrace() as trace:                 # one more replay
            serve(cams, 0, click)
        on_card = {k: trace.counts[k] for k in launches}
        runs[name] = dict(frame_ms=ms, frame_ms_all=times, culled=_share(counts),
                          launches=launches, launches_per_frame=on_card,
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"cull {name:8s} {H}x{W} int8 fused: median frame {ms:.2f} ms "
              f"({', '.join(f'{t:.1f}' for t in times)}); culled "
              + ", ".join(f"{k} {100 * v:.1f} %" for k, v in runs[name]["culled"].items())
              + "; on the card a replay " + " ".join(f"{k}={v:g}" for k, v in on_card.items())
              + ", launched by the eager frame and the capture "
              + " ".join(f"{k}={v:g}" for k, v in launches.items())
              + f"; max_memory_allocated={runs[name]['max_memory_allocated'] / 2**30:.2f} GiB",
              flush=True)
        if on_card != {"F32-ENC": 0, "Q-ENC": 0, "FUSED-QMLP": FUSED_PER_FRAME} \
                or launches != {k: 2 * v for k, v in on_card.items()}:
            raise AssertionError(f"culled frames ({name}) launched {launches} and ran "
                                 f"{on_card} on the card in a replay")
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
    _reset_encode_launches()
    for d, model in models.items():
        model.config = dataclasses.replace(model.config, serve_transmittance_eps=eps)
        renderer = SamNerfRenderer(model, chunk=2048, serve_preset="static").renderer
        with _culled_share() as counts:
            grids = renderer.render_image_device(_cameras(d, 1, 64, 64, CULL_REF_FOCAL), 0,
                                                 64, 64, ("sam", "clipseg"),
                                                 occ=pack_serve_occupancy(cells, device=d))
        outs[d] = ({k: v.cpu() for k, v in grids.items()}, _share(counts))
    launches = _encode_launches()
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


def _u8(image):
    """A float image in [0, 1] as the render thread sends it: uint8."""
    return (np.clip(np.asarray(image, np.float32), 0, 1) * 255).astype(np.uint8)


def _jpeg_of(image_u8):
    """The decoded quality-``VIEWER_JPEG_QUALITY`` JPEG of a uint8 image,
    in [0, 1]."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image_u8).save(buf, format="JPEG", quality=VIEWER_JPEG_QUALITY)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())), np.float32) / 255.0


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
    directory saved from the model.  Each broadcast image is matched to
    the ``render_view`` output it shows (its uint8 conversion, bit for
    bit), and each JPEG the client receives is that image's quality-70
    JPEG, bit for bit; the JPEG's own error is reported.
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
        before = _encode_launches()
        rm = state.render_machine
        row = dict(state=rm.state, preset=kw.get("preset"), h=h, w=w,
                   expected=rm._calculate_image_res(1.0), output=state.output_render)
        t0 = time.perf_counter()
        out = render_view(intrin, c2w, h, w, **kw)
        row["render_ms"] = (time.perf_counter() - t0) * 1e3
        row["points"] = 0 if kw.get("points") is None else len(kw["points"])
        row["launches"] = {k: v - before[k] for k, v in _encode_launches().items()}
        key = state.output_render if state.output_render in out else "rgb"
        row["image"] = np.clip(out[key], 0, 1)
        row["mask_fraction"] = float((np.abs(out["masked_rgb"] - out["rgb"]).max(-1)
                                      > 1e-6).mean())
        renders.append(row)
        return out

    state.render_view = recorded
    # the j-th image broadcast is the j-th the client receives: each notes
    # the render it shows, the newest whose output, converted as the render
    # thread converts it, is this image, and keeps the image
    frames, shown, sent = [], [], []
    set_background_image = state.server.set_background_image

    def noted(image, **kw):
        shown.append(next((i for i in range(len(renders) - 1, -1, -1)
                           if np.array_equal(_u8(renders[i]["image"]), image)), None))
        sent.append(image.copy())
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
                j = len(frames)
                if shown[j] is None:
                    raise AssertionError(f"viewer: the frame for {what} shows no render")
                frames.append(dict(what=what, latency_ms=(time.perf_counter() - sent_at) * 1e3,
                                   image=_jpeg(msg), render=shown[j],
                                   exact=np.array_equal(_jpeg(msg), _jpeg_of(sent[j]))))
                return frames[-1]
        raise AssertionError(f"viewer: no frame for {what} in {VIEWER_TIMEOUT} s")

    def send(ws, msg, what, n_frames=1):
        t0 = time.perf_counter()
        ws.send(msg.serialize())
        return [expect_frame(ws, t0, what) for _ in range(n_frames)]

    _reset_encode_launches()
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
    launches = _encode_launches()
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
    if not all(f["exact"] for f in frames):
        raise AssertionError(f"viewer: JPEGs that are not the quality-{VIEWER_JPEG_QUALITY} "
                             f"JPEG of their render: {[f['what'] for f in frames if not f['exact']]}")
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
    print(f"viewer: {len(frames)} frames, each the JPEG of its render bit for bit (JPEG "
          f"mean abs err max {max(errs):.4f}); 1 locked point; launches {launches}; "
          "max_memory_allocated="
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


VIEWER_TRAIN_STEPS = 60         # 3 blocks; the viewer re-renders at multiples of 30


def viewer_train_phase(dev, scene: Path, root: Path, train_step_ms: float):
    """``train.train_loop`` with ``--vis viewer`` at full width on the
    train phase's synthetic scene, free ports, 60 steps in the preset's
    blocks of 20: the first runs eagerly and is captured, the other two
    are replays, all with the viewer live (its every-30-steps re-render
    fires at 60).  The attach is watched: a failure raises after the run
    (no "viewer unavailable").  A client connects as the viewer starts,
    sends a camera and must get a frame before the last step ends.  Step
    ms of the replays with the viewer attached beside the train phase's;
    F32-ENC / F32-ENC-BWD launched against the steps Python ran and the
    frames, and on the card (a trace of the last block) against
    the replayed steps; finite losses, and the viewer stopped with the
    run."""
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

    losses, times, last, last_step = [], [], [0.0, 0], [0.0]
    trace = _CardTrace()

    def on_step(step, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step > DISPATCH_BLOCK:
            times.append((now - last[0]) * 1e3 / (step - last[1]))
        if step == VIEWER_TRAIN_STEPS - DISPATCH_BLOCK:
            trace.start()                       # the last block (see _CardTrace)
            now = time.perf_counter()           # the trace's start is not timed
        last[:] = now, step
        last_step[0] = now

    _reset_encode_launches()
    train_entry._launch_viewer = watched
    try:
        trainer = train_entry.train_loop(config, device=dev, step_callback=on_step)
    finally:
        if trace.running:
            trace.stop()
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
    on_card = {k: trace.counts[k] for k in launches}
    dispatched = dict(trainer.steps_by_dispatch)
    del trainer
    before_end = [f for f in frames if f[0] <= last_step[0]]
    step_ms = statistics.median(times)
    result = dict(step_ms=step_ms, step_ms_all=times, train_phase_step_ms=train_step_ms,
                  steps=VIEWER_TRAIN_STEPS, steps_by_dispatch=dispatched, frames=len(renders),
                  frame_sizes=renders, frames_received=len(frames),
                  frames_before_end=len(before_end), launches=launches,
                  replays_on_card=on_card, first_losses=losses[0], last_losses=losses[-1])
    print(f"viewer_train: {VIEWER_TRAIN_STEPS} steps with the viewer attached "
          f"({dispatched}), median step of the replays {step_ms:.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in times)}; train phase {train_step_ms:.2f}); "
          f"{len(renders)} viewer frames {sorted(set(renders))}, {len(frames)} received, "
          f"{len(before_end)} before the last step; launched {launches}, on the card in "
          f"the last block {on_card}; losses after the first block {losses[0]}, "
          f"the last {losses[-1]}", flush=True)
    if not before_end:
        raise AssertionError("viewer_train: no frame reached the client during training")
    if not all(math.isfinite(v) for r in losses for v in r.values()):
        raise AssertionError(f"viewer_train losses: {losses}")
    if any(hw != (VIEW_SIZE, VIEW_SIZE) for hw in renders):
        raise AssertionError(f"viewer_train: frames at {renders}")
    # Python ran the first block eagerly and into the graph; the frames
    # render eagerly; a frame may be in flight as the trace starts
    ran = dispatched["eager"] + dispatched["captured"]
    replayed = VIEWER_TRAIN_STEPS - DISPATCH_BLOCK
    want = {"F32-ENC": F32_PER_STEP * ran + F32_PER_FRAME * len(renders),
            "F32-ENC-BWD": F32_PER_STEP * ran, "Q-ENC": 0}
    if dispatched != {"eager": DISPATCH_BLOCK, "captured": DISPATCH_BLOCK,
                      "replayed": replayed} or launches != want \
            or on_card["F32-ENC-BWD"] != F32_PER_STEP * DISPATCH_BLOCK or on_card["Q-ENC"] \
            or not 0 <= on_card["F32-ENC"] - F32_PER_STEP * DISPATCH_BLOCK \
            <= F32_PER_FRAME * len(renders):
        raise AssertionError(f"viewer_train ran {dispatched}, launched {launches} (not "
                             f"{want}) and ran {on_card} on the card in {DISPATCH_BLOCK} "
                             f"traced replayed steps ({trace.records} device records) and "
                             f"{len(renders)} frames")
    return result


# --- DINO distillation ------------------------------------------------------

DINO_STRIDE = 4
DINO_TIMED_IMAGES = 5           # timed extractions after a warm-up
DINO_CHUNKS = (1024, 2048, 4096, 8192, None)    # query rows per attention product
DINO_REF_SIZE = 64              # the card-vs-CPU image (a 15 x 15 patch grid)
TOL_DINO = 1e-4                 # max abs error / max |CPU descriptor|, f32, 12 layers
DINO_TRAIN_STEPS = 80           # timed, in blocks of 20, after one block


def _timed_train(config, dev, what: str, warmup: int = DISPATCH_BLOCK,
                 steps: int = 2 * DISPATCH_BLOCK):
    """``train.train_loop`` over ``warmup + steps`` steps in the preset's
    blocks of ``steps_per_dispatch`` (by default one block that runs
    eagerly and is captured, then two replays; runs shorter than a block
    take single steps): (trainer, the losses of each dispatch, ms per step
    of each dispatch after the warm-up, the encodes that ran on the card
    per step, peak memory over the timed steps).  Where the timed steps
    are replays, one more block is replayed after them under a profiler
    trace (untimed; see ``_CardTrace``) and its kernels are counted by
    name; single steps are counted by the wrappers (untraced).  Raises
    unless every loss is finite, each counted step ran ``F32_PER_STEP``
    F32-ENC and F32-ENC-BWD and no Q-ENC, and the wrappers launched as
    many for every step Python ran (eagerly or into the graph)."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.ops import hash_grid as hg

    names = ("F32-ENC", "F32-ENC-BWD", "Q-ENC")
    block = config.trainer.steps_per_dispatch
    replays = warmup >= block > 1               # the timed steps are graph replays
    losses, times, last, before = [], [], [0.0, 0], {}
    trace = _CardTrace()

    def wrappers():
        return {"F32-ENC": hg.parity_hash_encode.launches,
                "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                "Q-ENC": hg.parity_hash_encode_q8.launches}

    def on_step(step, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step == warmup:
            torch.cuda.reset_peak_memory_stats()
            before.update(wrappers())
        elif warmup < step <= warmup + steps:
            times.append((now - last[0]) * 1e3 / (step - last[1]))
        if step == warmup + steps:
            peak[0] = torch.cuda.max_memory_allocated()
            if replays:
                trace.start()
        last[:] = now, step

    traced = block if replays else 0
    peak = [0]
    config.trainer.max_num_iterations = warmup + steps + traced
    _reset_encode_launches()
    try:
        trainer = train_entry.train_loop(config, device=dev, step_callback=on_step)
    finally:
        if trace.running:
            trace.stop()
    python = wrappers()
    counted = traced or steps
    launches = ({k: trace.counts[k] for k in names} if replays
                else {k: python[k] - before[k] for k in names})
    ran = trainer.steps_by_dispatch["eager"] + trainer.steps_by_dispatch["captured"]
    if trainer.state.step != warmup + steps + traced or not all(
            math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"{what}: step {trainer.state.step}, losses {losses}")
    if launches != {"F32-ENC": F32_PER_STEP * counted, "F32-ENC-BWD": F32_PER_STEP * counted,
                    "Q-ENC": 0} or python != {"F32-ENC": F32_PER_STEP * ran,
                                              "F32-ENC-BWD": F32_PER_STEP * ran, "Q-ENC": 0} \
            or trainer.steps_by_dispatch["replayed"] != (steps + traced if replays else 0):
        raise AssertionError(f"{what} ran {launches} on the card in {counted} "
                             f"{'traced' if replays else 'timed'} steps ({trace.records} "
                             f"device records traced) and launched {python} in {ran} "
                             f"({trainer.steps_by_dispatch}), not {F32_PER_STEP} + "
                             f"{F32_PER_STEP} per step")
    return trainer, losses, times, launches, counted, peak[0]


def dino_phase(dev, root: Path, train_step_ms: float):
    """A seeded ``dino_vits8.pth`` (reference layout, 21.7 M parameters);
    descriptors of the train phase's synthetic scene (24 + 2 images at
    512x512: 127 x 127 patches at stride 4, layer 11 ``key``) through
    ``ViTExtractor`` (ms per image and peak memory by query rows per
    attention product, ``DINO_CHUNKS``) and ``get_dino_embeddings.main``;
    a small image's descriptors on the card against the CPU; then one
    block and ``DINO_TRAIN_STEPS`` full-width ``samnerf_distill`` steps
    with ``--model.use-dino-feature True --datamanager.use-dino-feature
    True`` through the train entry, in the preset's blocks: the first
    captured, the others replays (step ms beside the train phase's, the
    DINO loss of the last blocks below the first ones', 6 + 6 launches a
    step on the card in one more replayed block under a trace).  Returns
    the result and the scene."""
    from PIL import Image

    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.preprocessing import get_dino_embeddings as gde
    from samnerf_tpu_torch.utils.synthetic import write_scene

    ckpt = root / "dino_vits8.pth"
    state = gde.seeded_dino_state_dict("dino_vits8", seed=11)
    torch.save(state, ckpt)
    num_params = sum(v.numel() for v in state.values())
    scene = write_scene(root / "scene_dino", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    paths = gde.image_paths(scene / "images")
    with Image.open(paths[0]) as im:
        grid = tuple(1 + (side - 8) // DINO_STRIDE for side in im.size[::-1])
    timed = {}
    for chunk in DINO_CHUNKS:
        tag = "whole" if chunk is None else str(chunk)
        ex = gde.ViTExtractor("dino_vits8", DINO_STRIDE, checkpoint=str(ckpt),
                              query_chunk=chunk, device=dev)
        ex.extract_descriptors(ex.preprocess(paths[0]))                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for p in paths[1:1 + DINO_TIMED_IMAGES]:
            batch = ex.preprocess(p)
            t0 = time.perf_counter()
            desc = ex.extract_descriptors(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        timed[tag] = dict(ms=statistics.median(times), ms_all=times,
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        if desc.shape != (1, 1, grid[0] * grid[1], 384) or ex.num_patches != grid:
            raise AssertionError(f"DINO descriptors {desc.shape} on {ex.num_patches}")
        del ex
    # a small image, card against CPU
    img = np.random.default_rng(12).integers(0, 256, (DINO_REF_SIZE, DINO_REF_SIZE, 3),
                                             dtype=np.uint8)
    outs = {}
    for d in (dev, "cpu"):
        ex = gde.ViTExtractor("dino_vits8", DINO_STRIDE, checkpoint=str(ckpt), device=d)
        outs[str(d)] = ex.extract_descriptors(ex.preprocess(img))
    ref = outs["cpu"]
    ref_err = float(np.abs(outs[str(dev)] - ref).max() / np.abs(ref).max())
    t0 = time.perf_counter()
    gde.main([str(scene / "images"), "--output-path", str(scene / "dino_features"),
              "--checkpoint", str(ckpt)], device=dev)
    main_s = time.perf_counter() - t0
    files = sorted((scene / "dino_features").glob("*.pt"))
    first = torch.load(files[0])
    train_names = [f["file_path"] for f in json.loads(
        (scene / "transforms_train.json").read_text())["frames"]]
    host_bytes = sum(torch.load(scene / "dino_features" / (Path(n).stem + ".pt")).nbytes
                     for n in train_names)
    default = timed[str(gde.QUERY_CHUNK)]
    print(f"dino: seeded dino_vits8 ({num_params / 1e6:.2f} M parameters), 512x512 at "
          f"stride {DINO_STRIDE} ({first.shape[0]}x{first.shape[1]} patches): "
          f"{default['ms']:.1f} ms per image "
          f"({', '.join(f'{t:.1f}' for t in default['ms_all'])}), peak "
          f"{default['max_memory_allocated'] / 2**30:.2f} GiB with {gde.QUERY_CHUNK}-query "
          "chunks (the default); by query rows per product: "
          + ", ".join(f"{k} {v['ms']:.1f} ms / {v['max_memory_allocated'] / 2**30:.2f} GiB"
                      for k, v in timed.items())
          + f"; main() wrote {len(files)} files in {main_s:.1f} s, "
          f"{tuple(first.shape)} each, train split {host_bytes / 1e6:.1f} MB on the host; "
          f"{DINO_REF_SIZE}x{DINO_REF_SIZE} card vs CPU max err {ref_err:.2e} of max |desc| "
          f"(tol {TOL_DINO:g})", flush=True)
    if len(files) != len(paths) or tuple(first.shape) != (*grid, 384) \
            or first.dtype != torch.float32:
        raise AssertionError(f"get_dino_embeddings wrote {len(files)} files {first.shape}")
    if not ref_err <= TOL_DINO:
        raise AssertionError(f"DINO descriptors: card vs CPU {ref_err:.2e} > {TOL_DINO}")

    config = train_entry.parse([
        "samnerf_distill", "--data", str(scene), "--model.use-dino-feature", "True",
        "--datamanager.use-dino-feature", "True", "--vis", "none",
        "--trainer.save-final", "false", "--trainer.output-dir", str(root / "out_dino")])
    trainer, losses, times, launches, counted, peak = _timed_train(
        config, dev, "the DINO train path", steps=DINO_TRAIN_STEPS)
    if trainer.get_features != ("sam", "dino", "clipseg") \
            or tuple(trainer.device_data["dino_features"].shape) != (len(train_names), *grid,
                                                                    384):
        raise AssertionError(f"DINO trainer: {trainer.get_features}")
    rays = trainer.datamanager.config.train_num_rays_per_batch
    del trainer
    dino = [m["dino_loss"] for m in losses]
    step_ms = statistics.median(times)
    result = dict(num_params=num_params, extract=timed, main_s=main_s, files=len(files),
                  feature_shape=list(first.shape), host_bytes=host_bytes,
                  card_vs_cpu_rel_err=ref_err, step_ms=step_ms, step_ms_all=times,
                  train_phase_step_ms=train_step_ms, rays_per_s=rays / step_ms * 1e3,
                  launches=launches, traced_steps=counted,
                  launches_per_step={k: v / counted for k, v in launches.items()},
                  max_memory_allocated=peak, dino_loss=dino,
                  first_losses=losses[0], last_losses=losses[-1])
    print(f"train_dino samnerf_distill --model.use-dino-feature True, {rays} rays/step: "
          f"median step {step_ms:.2f} ms over {len(times)} replays of {DISPATCH_BLOCK} steps "
          f"({', '.join(f'{t:.2f}' for t in times)}; train phase {train_step_ms:.2f}), "
          f"{result['rays_per_s']:,.0f} rays/s; on the card a step "
          + ", ".join(f"{k}={v:g}" for k, v in result["launches_per_step"].items())
          + f"; max_memory_allocated={peak / 2**30:.2f} GiB; dino_loss {dino[0]:.4f} -> "
          f"{dino[-1]:.4f}", flush=True)
    if not statistics.mean(dino[-2:]) < statistics.mean(dino[:2]):
        raise AssertionError(f"the DINO loss did not fall: {dino}")
    return result, scene


# --- data beyond the nerfstudio format ----------------------------------------

DATA_TRAIN_STEPS = 5            # full-width steps per routed scene, the first a warm-up
DATA_RAYS = 4096                # rays held card against CPU per scene
TOL_RAY_DIR = 1e-5              # unit directions, card vs CPU
TOL_RAY_AREA = 1e-3             # pixel areas, relative
DISTORTION = dict(k1=0.04, k2=-0.01, k3=0.002, p1=0.002, p2=-0.001)
DATA_PATH_SIZES = {"fisheye": (256, 256), "equirectangular": (256, 512)}
DATA_SERVE_SIZE = 512


def _pose(i: int):
    m = np.eye(4)
    m[:3, :3] = np.array([[np.cos(0.3 * i), -np.sin(0.3 * i), 0.0],
                          [np.sin(0.3 * i), np.cos(0.3 * i), 0.0], [0.0, 0.0, 1.0]])
    m[:3, 3] = [0.1 * i, -0.05 * i, 1.0 + 0.1 * i]
    return m


def family_scenes(root: Path):
    """A minimal scene of each dataparser family (the layouts the JAX
    package's tests write) parsed by the port: {family: outputs}."""
    import struct

    from samnerf_tpu_torch.data import dataparsers_extra as dpe

    out = {}

    def make(name):
        d = root / name
        d.mkdir(parents=True)
        return d

    def frames(key="transform_matrix", n=4, **extra):
        return [{"file_path": f"./train/r_{i}", key: _pose(i).tolist(), **extra}
                for i in range(n)]

    d = make("blender")
    (d / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames()}))
    out["blender"] = dpe.parse_blender_data(dpe.BlenderDataparserConfig(data=d))
    d = make("dnerf")
    (d / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": [dict(f, time=i / 3) for i, f in
                                           enumerate(frames())]}))
    out["dnerf"], _ = dpe.parse_dnerf_data(dpe.DNeRFDataparserConfig(data=d))
    d = make("instant_ngp")
    (d / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": 0.9, "cx": 320.0, "cy": 240.0, "h": 480, "w": 640,
         "aabb_scale": 4, "frames": frames()}))
    out["instant_ngp"] = dpe.parse_instant_ngp_data(dpe.InstantNGPDataparserConfig(data=d))
    d = make("minimal")
    np.savez(d / "train.npz", poses=np.stack([_pose(i)[:3] for i in range(2)]),
             image_filenames=np.array(["a.png", "b.png"]), fx=100.0, fy=101.0, cx=32.0,
             cy=30.0, height=64, width=64)
    out["minimal"] = dpe.parse_minimal_data(dpe.MinimalDataparserConfig(data=d))
    d = make("phototourism")
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, 640, 480)
                + struct.pack("<4d", 400.0, 410.0, 320.0, 240.0))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for iid, name in ((1, b"a.png"), (2, b"b.png")):
            q = np.array([1.0, 0.1 * iid, -0.2, 0.05])
            f.write(struct.pack("<I", iid) + struct.pack("<4d", *(q / np.linalg.norm(q)))
                    + struct.pack("<3d", 0.0, 0.1, float(iid)) + struct.pack("<I", 1)
                    + name + b"\x00" + struct.pack("<Q", 0))
    out["phototourism"] = dpe.parse_phototourism_data(
        dpe.PhototourismDataparserConfig(data=d))
    d = make("sdfstudio")
    (d / "meta_data.json").write_text(json.dumps(
        {"height": 48, "width": 64, "frames": [
            {"rgb_path": f"rgb/{i}.png", "camtoworld": _pose(i).tolist(),
             "intrinsics": [[50, 0, 32, 0], [0, 50, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1]]}
            for i in range(2)]}))
    out["sdfstudio"] = dpe.parse_sdfstudio_data(dpe.SDFStudioDataparserConfig(data=d))
    d = make("scannet")
    for sub in ("intrinsic", "pose", "color"):
        (d / sub).mkdir()
    np.savetxt(d / "intrinsic" / "intrinsic_color.txt", np.diag([500.0, 505.0, 1.0, 1.0]))
    for i in range(2):
        np.savetxt(d / "pose" / f"{i}.txt", _pose(i))
    out["scannet"] = dpe.parse_scannet_data(dpe.ScanNetDataparserConfig(data=d))
    d = make("arkitscenes")
    (d / "lowres_wide_intrinsics").mkdir()
    traj = []
    for i, ts in enumerate(("100.000", "100.500")):
        traj.append(f"{ts} 0.1 {0.2 * i} -0.05 {i * 0.3} 0.1 1.5")
        (d / "lowres_wide_intrinsics" / f"{ts}.pincam").write_text(
            f"256 192 {210 + i} {211 + i} 128.5 96.5")
    (d / "lowres_wide.traj").write_text("\n".join(traj))
    out["arkitscenes"] = dpe.parse_arkitscenes_data(dpe.ARKitScenesDataparserConfig(data=d))
    d = make("dycheck")
    (d / "camera").mkdir()
    (d / "dataset.json").write_text(json.dumps({"train_ids": ["0_00000", "0_00001"]}))
    for i, name in enumerate(("0_00000", "0_00001")):
        (d / "camera" / f"{name}.json").write_text(json.dumps(
            {"orientation": _pose(i)[:3, :3].tolist(), "position": [0, 0, 1 + i],
             "focal_length": 100.0, "principal_point": [32, 24], "image_size": [64, 48]}))
    out["dycheck"], _ = dpe.parse_dycheck_data(dpe.DycheckDataparserConfig(data=d))
    d = make("sitcoms3d")
    (d / "cameras.json").write_text(json.dumps(
        {"frames": [{"intrinsics": [[100, 0, 64], [0, 100, 48], [0, 0, 1]],
                     "camtoworld": _pose(i).tolist(), "image_name": f"f{i}.png"}
                    for i in range(2)], "aabb": [[-2, -2, -2], [2, 2, 2]]}))
    out["sitcoms3d"] = dpe.parse_sitcoms3d_data(dpe.Sitcoms3DDataparserConfig(data=d))
    d = make("nuscenes")
    tdir = d / "v1.0-mini"
    tdir.mkdir()
    tables = {"scene": [{"token": "sc0", "name": "scene-0001"}], "sample": [],
              "sample_data": [], "ego_pose": [], "calibrated_sensor": [],
              "sensor": [{"token": "se0", "channel": "CAM_FRONT", "modality": "camera"}]}
    for i in range(10):
        tables["sample"].append({"token": f"s{i}", "scene_token": "sc0",
                                 "timestamp": 1000 + i})
        tables["ego_pose"].append({"token": f"e{i}", "rotation": [1.0, 0.0, 0.0, 0.1 * i],
                                   "translation": [float(i), 0.2 * i, 1.5]})
        tables["calibrated_sensor"].append(
            {"token": f"c{i}", "sensor_token": "se0", "rotation": [0.5, -0.5, 0.5, -0.5],
             "translation": [1.5, 0.0, 1.6], "camera_intrinsic": [
                 [1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]]})
        tables["sample_data"].append(
            {"token": f"sd{i}", "sample_token": f"s{i}", "ego_pose_token": f"e{i}",
             "calibrated_sensor_token": f"c{i}", "is_key_frame": True,
             "filename": f"samples/CAM_FRONT/img_{i}.jpg"})
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    out["nuscenes"] = dpe.parse_nuscenes_data(dpe.NuScenesDataparserConfig(
        data="scene-0001", data_dir=d))
    return out


def _rays_card_vs_cpu(cameras, dev, seed: int, rays: int = DATA_RAYS):
    """(max direction error, max relative pixel-area error, origins equal)
    of ``rays`` random pixels' rays generated on the card and on the CPU."""
    from samnerf_tpu_torch.core.cameras import generate_rays

    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, cameras.num_cameras, rays))
    coords = torch.from_numpy(np.stack([rng.integers(0, cameras.height, rays),
                                        rng.integers(0, cameras.width, rays)], -1))
    cpu = generate_rays(cameras, idx, coords)
    card = generate_rays(cameras.to(dev), idx.to(dev), coords.to(dev))
    d_err = float((card.directions.cpu() - cpu.directions).abs().max())
    a_err = float(((card.pixel_area.cpu() - cpu.pixel_area).abs()
                   / cpu.pixel_area.abs().clamp_min(1e-30)).max())
    same_o = bool(torch.equal(card.origins.cpu(), cpu.origins))
    return d_err, a_err, same_o


def _formatted_scenes(scene: Path, root: Path):
    """The synthetic scene in three more layouts over its images and
    feature maps (symlinked): Blender (``camera_angle_x``), instant-ngp
    (``aabb_scale``, OpenCV-flipped rotations, the field of view) and
    nerfstudio with a shared OpenCV distortion."""
    train = json.loads((scene / "transforms_train.json").read_text())
    test = json.loads((scene / "transforms_test.json").read_text())
    angle = 2.0 * math.atan(train["w"] / (2.0 * train["fl_x"]))
    dirs = {}
    for name in ("blender", "instant_ngp", "distorted"):
        d = root / f"scene_{name}"
        d.mkdir()
        for sub in ("images", "sam_features", "clipseg_features"):
            (d / sub).symlink_to(scene / sub, target_is_directory=True)
        dirs[name] = d
    for split, meta in (("train", train), ("test", test)):
        (dirs["blender"] / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": angle, "frames": [
                {"file_path": "./" + f["file_path"][:-len(".png")],
                 "transform_matrix": f["transform_matrix"]} for f in meta["frames"]]}))
        (dirs["distorted"] / f"transforms_{split}.json").write_text(json.dumps(
            {**meta, **DISTORTION}))
    flipped = []
    for f in train["frames"] + test["frames"]:
        m = np.array(f["transform_matrix"])
        m[0:3, 1:3] *= -1
        flipped.append({"file_path": f["file_path"], "transform_matrix": m.tolist()})
    (dirs["instant_ngp"] / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": angle, "cx": train["cx"], "cy": train["cy"], "h": train["h"],
         "w": train["w"], "aabb_scale": 4, "frames": flipped}))
    return dirs


def _camera_path(kind: str, h: int, w: int):
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w

    frames = []
    for i in range(2):
        ang = 0.4 + 0.5 * i
        c2w = look_at_c2w(np.array([2.0 * math.cos(ang), 2.0 * math.sin(ang), 0.8]),
                          np.zeros(3))
        frames.append({"camera_to_world": c2w.reshape(-1).tolist(), "fov": 70.0,
                       "aspect": w / h})
    return {"camera_type": kind, "render_height": h, "render_width": w,
            "camera_path": frames, "fps": 24, "seconds": 1}


def data_phase(dev, scene: Path, root: Path, train_step_ms: float):
    """Every dataparser family's scene parsed, its rays on the card
    against the CPU; the synthetic scene as a Blender and an instant-ngp
    directory routed by ``_detect_parser``, each trained
    ``DATA_TRAIN_STEPS`` full-width single steps through the train entry;
    the scene with a shared OpenCV distortion (rays card vs CPU, trained
    in the preset's blocks, one captured and two replayed, its run
    directory rendered along fisheye and equirectangular camera paths by
    ``scripts/render.py``); the scene trained with appearance embeddings in
    those blocks and served as baked int8 512x512 frames, fused and not
    (FUSED-QMLP and Q-ENC launches)."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.core.camera_paths import get_path_from_json
    from samnerf_tpu_torch.data import dataparsers_extra as dpe
    from samnerf_tpu_torch.data.datamanager import _detect_parser
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.scripts import render as render_script
    from PIL import Image

    families = {}
    for i, (name, out) in enumerate(family_scenes(root / "families").items()):
        d_err, a_err, same_o = _rays_card_vs_cpu(out.cameras, dev, seed=i)
        families[name] = dict(cameras=out.cameras.num_cameras,
                              size=[out.cameras.height, out.cameras.width],
                              dir_err=d_err, area_rel_err=a_err, origins_equal=same_o)
        if d_err > TOL_RAY_DIR or a_err > TOL_RAY_AREA or not same_o:
            raise AssertionError(f"{name} rays card vs CPU: {families[name]}")
    print(f"data families: {len(families)} parsed ("
          + ", ".join(f"{k} {v['cameras']}" for k, v in families.items())
          + f"); rays card vs CPU max direction err "
          f"{max(v['dir_err'] for v in families.values()):.2e} (tol {TOL_RAY_DIR:g}), "
          f"pixel area {max(v['area_rel_err'] for v in families.values()):.2e} "
          f"(tol {TOL_RAY_AREA:g})", flush=True)
    if len(families) != len(dpe.dataparser_registry) - 1:      # all but nerfstudio's
        raise AssertionError(f"families {sorted(families)}")

    dirs = _formatted_scenes(scene, root)
    routed, runs = {}, {}
    for name, parser, family in (
            ("blender", dpe.parse_blender_data, dpe.BlenderDataparserConfig),
            ("instant_ngp", dpe.parse_instant_ngp_data, dpe.InstantNGPDataparserConfig)):
        got = _detect_parser(DataparserConfig(data=dirs[name]))(
            DataparserConfig(data=dirs[name]), "train")
        want = parser(family(data=dirs[name]), "train")
        routed[name] = (got.image_filenames == want.image_filenames
                        and torch.equal(got.cameras.fx, want.cameras.fx)
                        and got.dataparser_transform.shape == (3, 4))
        config = train_entry.parse([
            "samnerf_distill", "--data", str(dirs[name]), "--vis", "none",
            "--trainer.save-final", "false", "--trainer.output-dir", str(root / f"out_{name}")])
        trainer, losses, times, launches, _, _ = _timed_train(
            config, dev, f"the {name} train path", 1, DATA_TRAIN_STEPS - 1)
        runs[name] = dict(step_ms=statistics.median(times), launches=launches,
                          images=trainer.datamanager.num_train_images,
                          last_losses=losses[-1])
        del trainer
    if not all(routed.values()):
        raise AssertionError(f"_detect_parser routed {routed}")

    # the distorted scene: its rays, a run directory, camera paths
    config = train_entry.parse([
        "samnerf_distill", "--data", str(dirs["distorted"]), "--vis", "none",
        "--trainer.output-dir", str(root / "run_distorted")])
    train_entry.save_config(config)
    trainer, losses, times, launches, _, _ = _timed_train(
        config, dev, "the distorted train path")
    cams = trainer.datamanager.cameras
    if cams.distortion_params is None:
        raise AssertionError("the distorted scene parsed without distortion")
    d_err, a_err, same_o = _rays_card_vs_cpu(cams, dev, seed=99, rays=16384)
    runs["distorted"] = dict(step_ms=statistics.median(times), launches=launches,
                             dir_err=d_err, area_rel_err=a_err, last_losses=losses[-1])
    if d_err > TOL_RAY_DIR or a_err > TOL_RAY_AREA or not same_o:
        raise AssertionError(f"distorted rays card vs CPU: {runs['distorted']}")
    renders = {}
    for kind, (h, w) in DATA_PATH_SIZES.items():
        path_file = root / f"path_{kind}.json"
        path_file.write_text(json.dumps(_camera_path(kind, h, w)))
        out_dir = root / f"frames_{kind}"
        t0 = time.perf_counter()
        rc = render_script.main([str(root / "run_distorted"), "--traj", "filename",
                                 "--camera-path-filename", str(path_file), "--output",
                                 str(out_dir)], device=dev)
        ms = (time.perf_counter() - t0) * 1e3
        frames = sorted(out_dir.glob("frame_*.png"))
        path_cams = get_path_from_json(json.loads(path_file.read_text())).to(dev)
        ref = ImageRenderer(trainer.model).render_image(path_cams, 0)["rgb"]
        first = np.asarray(Image.open(frames[0])).astype(np.int64)
        diff = int(np.abs(first - (np.clip(ref, 0, 1) * 255).astype(np.int64)).max())
        renders[kind] = dict(rc=rc, frames=len(frames), shape=list(first.shape), ms=ms,
                             max_diff=diff)
        if rc != 0 or len(frames) != 2 or first.shape != (h, w, 3) or diff > 1:
            raise AssertionError(f"render.py {kind}: {renders[kind]}")
    del trainer

    # appearance embeddings: train, then serve baked int8 frames
    config = train_entry.parse([
        "samnerf_distill", "--data", str(scene), "--model.use-appearance-embedding", "True",
        "--vis", "none", "--trainer.save-final", "false",
        "--trainer.output-dir", str(root / "out_appearance")])
    trainer, losses, times, launches, _, _ = _timed_train(
        config, dev, "the appearance-embedding train path")
    emb = trainer.model.fields.embedding_appearance.weight
    runs["appearance"] = dict(step_ms=statistics.median(times), launches=launches,
                              embeddings=list(emb.shape), last_losses=losses[-1])
    if tuple(emb.shape) != (trainer.datamanager.num_train_images, 32):
        raise AssertionError(f"appearance embeddings {tuple(emb.shape)}")
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(0), device=dev))
    weights = trainer.model.state_dict()
    serve = {}
    for tag, fuse in (("int8_fused", True), ("int8", False)):
        model = SAMModel(dataclasses.replace(trainer.model_cfg, hash_q8_serve=True,
                                             serve_fuse_mlp=fuse), device=dev)
        model.load_state_dict(weights)
        snr = SamNerfRenderer(model, serve_preset="static")
        snr.bake_serve_tables()
        n = DATA_SERVE_SIZE
        fn = snr.serve_frame_fn(sam, n, n)
        _reset_encode_launches()
        fn(_cameras(dev, 0, n, n, 400.0 * n / 512), 0, (n / 2, n / 2))  # eager, capture
        python = _encode_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn(_cameras(dev, 1, n, n, 400.0 * n / 512), 0, (0.4 * n, 0.6 * n))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with _CardTrace() as trace:                 # one more replay
            fn(_cameras(dev, 1, n, n, 400.0 * n / 512), 0, (0.4 * n, 0.6 * n))
        serve[tag] = dict(frame_ms=ms, launches={k: trace.counts[k] for k in python},
                          python_launches=python)
        if img.dtype != torch.uint8 or tuple(img.shape) != (n, n, 3):
            raise AssertionError(f"appearance frame {img.dtype} {tuple(img.shape)}")
        del model, snr, fn
    del trainer
    if serve["int8_fused"]["launches"] != {"F32-ENC": 0, "Q-ENC": 0,
                                          "FUSED-QMLP": FUSED_PER_FRAME} \
            or serve["int8"]["launches"] != {"F32-ENC": 0, "Q-ENC": F32_PER_FRAME,
                                            "FUSED-QMLP": 0} \
            or any(r["python_launches"] != {k: 2 * v for k, v in r["launches"].items()}
                   for r in serve.values()):
        raise AssertionError(f"appearance serve launches {serve}")
    result = dict(families=families, routed=routed, runs=runs, renders=renders,
                  serve_appearance=serve, train_phase_step_ms=train_step_ms)
    print(f"data train (full width, median of {DATA_TRAIN_STEPS - 1} single steps after "
          f"one, or of 2 replays of {DISPATCH_BLOCK} steps after a captured block): "
          + ", ".join(f"{k} {v['step_ms']:.2f} ms" for k, v in runs.items())
          + f" (train phase {train_step_ms:.2f}); 6 + 6 launches a step; distorted rays "
          f"card vs CPU {runs['distorted']['dir_err']:.2e}; render.py fisheye "
          f"{renders['fisheye']['ms']:.0f} ms, equirectangular "
          f"{renders['equirectangular']['ms']:.0f} ms for 2 frames (diff "
          f"{max(r['max_diff'] for r in renders.values())}); appearance model 512x512 "
          f"int8 fused {serve['int8_fused']['frame_ms']:.1f} ms "
          f"({serve['int8_fused']['launches']}), int8 {serve['int8']['frame_ms']:.1f} ms "
          f"({serve['int8']['launches']})", flush=True)
    return result


# --- the model zoo ---------------------------------------------------------

ZOO_STEPS = 32                  # steps of each zoo method through the train entry
ZOO_NGP_STEPS = 288             # instant-ngp: the grid updates before steps 257 and 273
ZOO_WARMUP = 2                  # steps before the timed ones
ZOO_RAYS = 4096                 # rays per step, the zoo's default
ZOO_CLASSES = 16
ZOO_F32_PER_STEP = {"instant-ngp": 1, "depth-nerfacto": 2, "semantic-nerfw": 3}
"""F32-ENC and F32-ENC-BWD launches per step: the nerfacto field's
pyramid, the proposal network's, and semantic-NeRF-W's second read of
the field for its head."""
ZOO_F32_PER_CHUNK = {"instant-ngp": 1, "depth-nerfacto": 2, "semantic-nerfw": 2}
"""F32-ENC launches per 4096-ray eval chunk (semantic-NeRF-W evaluates
without its head)."""


def zoo_scene_extras(scene: Path, seed: int = 5):
    """Seeded depth maps (``depths/<stem>.npy`` in metres for the even
    images, 16-bit ``.png`` millimetres for the odd ones, zero, i.e. no
    depth, on a tenth of the pixels) and 16-class ``semantics/<stem>.png``
    masks (a class per 32x32 block) beside the scene's images.  Returns
    the images' (height, width)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (scene / "depths").mkdir(exist_ok=True)
    (scene / "semantics").mkdir(exist_ok=True)
    for i, img in enumerate(sorted((scene / "images").glob("*.png"))):
        w, h = Image.open(img).size
        depth = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
        depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
        if i % 2 == 0:
            np.save(scene / "depths" / f"{img.stem}.npy", depth)
        else:
            Image.fromarray(np.round(depth * 1000).astype(np.uint16)).save(
                scene / "depths" / f"{img.stem}.png")
        blocks = rng.integers(0, ZOO_CLASSES, (-(-h // 32), -(-w // 32)))
        classes = np.kron(blocks, np.ones((32, 32), np.int64))[:h, :w].astype(np.uint8)
        Image.fromarray(classes).save(scene / "semantics" / f"{img.stem}.png")
    return h, w


def _zoo_kernel_hold(dev, run):
    """F32-ENC and F32-ENC-BWD against their plain versions at the
    positions and cotangent of one instant-ngp train render (4096 rays x
    192 samples of the trained model, with its grid): one 16-level pyramid
    of one pack at 2^19 rows and the reference hash."""
    from samnerf_tpu_torch.core.cameras import generate_rays
    from samnerf_tpu_torch.ops import hash_grid as hg

    model, enc, cap = run.model, run.model.field.encoding, {}

    def hook(module, args, out):
        cap["positions"] = args[0].detach().clone()
        out.register_hook(lambda g: cap.setdefault("cotangent", g.detach().clone()))

    handle = enc.register_forward_hook(hook)
    gen = torch.Generator(device=dev).manual_seed(3)
    cams = _cameras(dev, 2, 512, 512, 400.0)
    idx = torch.randint(0, 512, (ZOO_RAYS, 2), generator=gen, device=dev)
    rb = generate_rays(cams, torch.zeros(ZOO_RAYS, dtype=torch.long, device=dev), idx)
    out = model(rb, train=True, generator=gen, occupancy=run.occupancy)
    out["rgb"].square().mean().backward()
    handle.remove()
    model.zero_grad(set_to_none=True)
    pos, g = cap["positions"], cap["cotangent"].contiguous()
    args = (pos, enc.scalings, enc.num_steps, enc.hash_fn)
    fwd_err = (hg.parity_hash_encode(enc.table.detach(), *args)
               - hg.parity_hash_encode_ref(enc.table.detach(), *args)).abs().max().item()
    grad, ref = hg.parity_hash_encode_bwd(g, *args), hg.parity_hash_encode_bwd_ref(g, *args)
    bwd_err = (grad - ref).abs().max().item()
    ratio = _tol_ratio(grad, ref, **TOL_TABLE_GRAD)
    del grad, ref
    hold = dict(points=pos.shape[0], levels=len(enc.scalings), packs=enc.table.shape[0]
                // len(enc.scalings), num_steps=enc.num_steps, hash_fn=enc.hash_fn,
                f32_enc_max_abs_err=fwd_err, f32_enc_bwd_max_abs_err=bwd_err,
                f32_enc_bwd_tol_ratio=ratio)
    if not (fwd_err <= TOL_KERNEL and math.isfinite(ratio) and ratio <= 1.0):
        raise AssertionError(f"the f32 kernels at instant-ngp's step disagree: {hold}")
    return hold


def zoo_phase(dev, scene: Path, root: Path):
    """Each of the eight zoo methods through ``train.main([method, "--data",
    scene, ...])`` at its default widths and 4096 rays a step (instant-ngp
    ``ZOO_NGP_STEPS``, the others ``ZOO_STEPS``): ms per step (median after
    ``ZOO_WARMUP``), rays/s, peak memory over the timed steps, the first
    and last losses (finite; the rgb loss falling), the eval PSNR of
    view 0 (finite) and its render's ms, and for the hash methods the
    F32-ENC / F32-ENC-BWD launches per step and per eval image; the
    instant-ngp grid's occupied share after each update (two, in (0, 1]);
    then F32-ENC and F32-ENC-BWD held against their plain versions at an
    instant-ngp step's positions."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.configs.zoo import zoo_methods
    from samnerf_tpu_torch.ops import hash_grid as hg

    h, w = zoo_scene_extras(scene)
    chunks = -(-h * w // train_entry.EVAL_CHUNK)     # eval view 0 is as large as the images
    results, hold = {}, None
    for name in zoo_methods():
        steps = ZOO_NGP_STEPS if name == "instant-ngp" else ZOO_STEPS
        losses, times, per_step, t_prev, counts = [], [], [], [0.0], {}
        runs = []

        def on_step(step, metrics):
            losses.append({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            now = time.perf_counter()
            launches = (hg.parity_hash_encode.launches, hg.parity_hash_encode_bwd.launches)
            if step == ZOO_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            elif step > ZOO_WARMUP:
                times.append((now - t_prev[0]) * 1e3)
                per_step.append((launches[0] - counts["last"][0]
                                 - ("occupied" in metrics), launches[1] - counts["last"][1]))
            if step == steps:
                counts["peak"] = torch.cuda.max_memory_allocated()
            counts["last"] = launches
            t_prev[0] = now

        _reset_encode_launches()
        rc = train_entry.main(
            [name, "--data", str(scene), "--max-num-iterations", str(steps),
             "--rays-per-batch", str(ZOO_RAYS), "--output-dir", str(root / "zoo"),
             "--log-every", str(steps)],
            device=dev, step_callback=on_step, run_callback=runs.append)
        run = runs[0]
        eval_launches = hg.parity_hash_encode.launches - counts["last"][0]
        rgb_key = "rgb_loss_fine" if "rgb_loss_fine" in losses[0] else "rgb_loss"
        rgb = [m[rgb_key] for m in losses]
        step_ms = statistics.median(times)
        res = dict(steps=steps, step_ms=step_ms, step_ms_all=times,
                   rays_per_s=ZOO_RAYS / step_ms * 1e3, max_memory_allocated=counts["peak"],
                   first_losses=losses[0], last_losses=losses[-1], rgb_loss_key=rgb_key,
                   psnr=run.psnr, eval_ms=run.eval_ms,
                   occupancy_updates=run.occupancy_updates,
                   f32_enc_per_step=sorted({a for a, _ in per_step}),
                   f32_enc_bwd_per_step=sorted({b for _, b in per_step}),
                   f32_enc_per_eval_image=eval_launches, eval_chunks=chunks)
        results[name] = res
        per = ZOO_F32_PER_STEP.get(name, 0)
        print(f"zoo {name}: {ZOO_RAYS} rays/step, median step {step_ms:.2f} ms over "
              f"{len(times)} steps, {res['rays_per_s']:,.0f} rays/s, peak "
              f"{counts['peak'] / 2**30:.2f} GiB; {rgb_key} {rgb[0]:.5f} -> {rgb[-1]:.5f}, "
              f"total {losses[0]['total_loss']:.5f} -> {losses[-1]['total_loss']:.5f}; "
              f"eval view 0 PSNR {run.psnr:.2f} ({run.eval_ms:.0f} ms for {h}x{w}); F32-ENC "
              f"{res['f32_enc_per_step']}/step, F32-ENC-BWD {res['f32_enc_bwd_per_step']}"
              f"/step, F32-ENC {eval_launches}/eval image"
              + (f"; grid updates (step, occupied share) {run.occupancy_updates}"
                 if run.occupancy_updates else ""), flush=True)
        if rc != 0 or not all(math.isfinite(v) for m in losses for v in m.values()) \
                or not math.isfinite(run.psnr):
            raise AssertionError(f"zoo {name}: rc {rc}, losses {losses[0]} -> {losses[-1]}, "
                                 f"PSNR {run.psnr}")
        if not statistics.mean(rgb[-4:]) < statistics.mean(rgb[:4]):
            raise AssertionError(f"zoo {name}: the rgb loss did not fall: {rgb}")
        if res["f32_enc_per_step"] != [per] or res["f32_enc_bwd_per_step"] != [per] \
                or eval_launches != ZOO_F32_PER_CHUNK.get(name, 0) * chunks:
            raise AssertionError(f"zoo {name}: launches per step F32-ENC "
                                 f"{res['f32_enc_per_step']}, F32-ENC-BWD "
                                 f"{res['f32_enc_bwd_per_step']}, not [{per}]; per eval "
                                 f"image {eval_launches} for {chunks} chunks")
        if name == "instant-ngp":
            if [s for s, _ in run.occupancy_updates] != [257, 273] or not all(
                    0.0 < share <= 1.0 for _, share in run.occupancy_updates):
                raise AssertionError(f"instant-ngp grid updates {run.occupancy_updates}")
            hold = _zoo_kernel_hold(dev, run)
            print(f"zoo kernels at an instant-ngp step ({hold['points']} points, "
                  f"{hold['levels']} levels x {hold['packs']} pack, {hold['num_steps']} "
                  f"steps, {hold['hash_fn']} hash): F32-ENC max abs err "
                  f"{hold['f32_enc_max_abs_err']:.2e} (tol {TOL_KERNEL:g}), F32-ENC-BWD "
                  f"{hold['f32_enc_bwd_max_abs_err']:.2e} ({hold['f32_enc_bwd_tol_ratio']:.3f}"
                  f" x tol)", flush=True)
        del run, runs
        torch.cuda.empty_cache()
    return dict(methods=results, kernel_hold=hold,
                launches={"F32-ENC": sum((r["f32_enc_per_step"][0] * len(r["step_ms_all"])
                                          for r in results.values())),
                          "F32-ENC-BWD": sum((r["f32_enc_bwd_per_step"][0]
                                              * len(r["step_ms_all"])
                                              for r in results.values()))})


ZOO_REF_RAYS = 256


def zoo_reference_phase(dev):
    """One small instant-ngp step (16 levels at 2^14 rows, 48 samples, a
    16^3 grid built on each device from the same cells and jitter) on the
    card vs on the CPU, where every kernel runs its plain version: the
    grid bit for bit, the losses, every gradient and the eval outputs."""
    from samnerf_tpu_torch.configs import zoo
    from samnerf_tpu_torch.core.cameras import generate_rays
    from samnerf_tpu_torch.models.instant_ngp import InstantNGPConfig, InstantNGPModel
    from samnerf_tpu_torch.ops.occupancy import update_occupancy

    cfg = InstantNGPConfig(num_samples=48, log2_hashmap_size=14)
    state = {k: v * 2000.0 if k.endswith("table") else v for k, v in zoo.init_zoo_params(
        InstantNGPModel(cfg, device="meta"), torch.Generator().manual_seed(0), "cpu").items()}
    g = torch.Generator().manual_seed(1)
    idx = torch.stack([torch.zeros(ZOO_REF_RAYS, dtype=torch.long),
                       torch.randint(0, 64, (ZOO_REF_RAYS,), generator=g),
                       torch.randint(0, 64, (ZOO_REF_RAYS,), generator=g)], -1)
    batch = {"indices": idx, "image": torch.rand((ZOO_REF_RAYS, 3), generator=g)}
    draws = {"jitter": (torch.rand((ZOO_REF_RAYS, 1), generator=g),),
             "bg_rgb": torch.rand((ZOO_REF_RAYS, 3), generator=g)}
    cells, jit = torch.randint(0, 16 ** 3, (2048,), generator=g), torch.rand((2048, 3),
                                                                          generator=g)
    method = zoo.zoo_methods()["instant-ngp"]
    outs = []
    for d in (torch.device(dev), torch.device("cpu")):
        model = InstantNGPModel(cfg, device=d)
        model.load_state_dict(state)
        _, grid = update_occupancy(torch.full((16 ** 3,), 0.005, device=d), model.density_fn,
                                   model.aabb, idx=cells.to(d), jitter=jit.to(d))
        cams = _cameras(d, 1, 64, 64, 50.0)
        losses, _ = zoo.zoo_loss_and_grads(
            method, model, cfg, cams, {k: v.to(d) for k, v in batch.items()},
            occupancy=grid, draws={k: tuple(x.to(d) for x in v) if isinstance(v, tuple)
                                   else v.to(d) for k, v in draws.items()})
        ev = model(generate_rays(cams, idx[:, 0].to(d), idx[:, 1:].to(d)), train=False,
                   occupancy=grid)
        outs.append((grid.cpu(), {k: v.item() for k, v in losses.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {k: v.cpu() for k, v in ev.items()}))
    (ga, la, gra, eva), (gb, lb, grb, evb) = outs
    loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb)
    ratios = {n: _tol_ratio(gra[n], grb[n], **(TOL_TABLE_GRAD if n.endswith("table")
                                               else TOL_DENSE_GRAD)) for n in grb}
    eval_err = max((eva[k] - evb[k]).abs().max().item() for k in evb)
    worst = max(ratios, key=ratios.get)
    report = dict(grid_equal=torch.equal(ga, gb), occupied=float(gb.mean()),
                  loss_max_rel_err=loss_err, grad_tol_ratio=ratios, worst=worst,
                  eval_max_abs_err=eval_err, losses=la)
    print(f"zoo reference: instant-ngp card vs CPU step, grid equal {report['grid_equal']} "
          f"(occupied {report['occupied']:.3f}), losses max rel err {loss_err:.2e} (tol "
          f"{TOL_LOSS:g}), gradients within {ratios[worst]:.3f} x tol at worst ({worst}), "
          f"eval max abs err {eval_err:.2e} (tol {TOL_FRAME:g})", flush=True)
    if not report["grid_equal"] or loss_err > TOL_LOSS or eval_err > TOL_FRAME \
            or not all(math.isfinite(r) and r <= 1.0 for r in ratios.values()):
        raise AssertionError(f"card and CPU instant-ngp steps disagree: {report}")
    return report


QUALITY_STEPS = 300             # of the mIoU study's 3000: the cut that fits the phase
QUALITY_RAYS = 16384
QUALITY_TABLES = (19, 17)       # log2 rows of the field and proposal tables: the reference's
QUALITY_GRID = 16               # point prompts a side on the held-out view (the study's 64)
QUALITY_ZOO_STEPS = 200         # instant-ngp through validate_zoo's runner
QUALITY_ZOO_SIZE = 128
QUALITY_DN_VIEWS = 64           # depth-nerfacto on validate_zoo --views 64's scene
QUALITY_DN_STEPS = 2000         # of the JAX run's 8000
QUALITY_DN_MARGIN = 3.0         # dB over the constant colour
QUALITY_DN_SEED = 3             # a seed that trains (zoo_depth_check's docstring)
LAUNCH_LINE = re.compile(r"hash kernel launches: F32-ENC (\d+), F32-ENC-BWD (\d+)")
SAVED_LINE = re.compile(r"eval view 0 PSNR: .*; saved (.+)$")
SCENE_DIGESTS = {
    "png_sha256": "c123bc465c02eaf0def982326192299ee4241e87e0f70018ecaf20bb832fa4f9",
    "pixels_sha256": "cff0727106456ef640074aaf0f23e72b59e0e25c65f8ca57cc0b38596dd7dfc3",
    "npy_sha256": "ec460e90be00d3fc10d1ef7a2f6338a0e0fd6ca9d3244e39334836995f12aad0",
}
"""The mIoU study's scene (24 + 4 views, 256x256, detail 4, with
features): the first image's PNG bytes, its pixels and its SAM ``.npy``,
as the JAX package writes them (``tests/test_torch_synthetic_textured.py``
computes them from it)."""


def scene_digests(scene: Path) -> dict:
    """SHA-256 of the first image's PNG bytes, of its decoded pixels and of
    its ``sam_features`` ``.npy``."""
    from PIL import Image

    png = scene / "images" / "frame_00000.png"
    return {"png_sha256": hashlib.sha256(png.read_bytes()).hexdigest(),
            "pixels_sha256": hashlib.sha256(np.asarray(Image.open(png)).tobytes()).hexdigest(),
            "npy_sha256": hashlib.sha256(
                (scene / "sam_features" / "frame_00000.npy").read_bytes()).hexdigest()}


def quality_phase(dev, root: Path):
    """The quality path, cut to size: the textured scene at the mIoU
    study's defaults (digests against the JAX package's); ViT-B targets
    on the card through ``quality_distill_miou.make_vit_features`` (ms per
    image, 4 FLASH-RELPOS launches per image, the first embedding against
    the plain-attention route); ``quality_capacity.train_and_eval`` at
    2^19 / 2^17, morton, 16384 rays for ``QUALITY_STEPS`` steps (step ms,
    rays/s, 6 F32-ENC and 6 F32-ENC-BWD launches a step run eagerly or
    captured, the other blocks replays, test PSNR, SSIM,
    SAM-feature MSE and cosine); ``view_miou`` on one held-out view at a
    ``QUALITY_GRID`` prompt grid; and instant-ngp through
    ``validate_zoo.run_method`` (its own process) for ``QUALITY_ZOO_STEPS``
    steps at 128x128, with its margin over ``trivial_psnr``; then
    depth-nerfacto on the 64-view scene (:func:`zoo_depth_check`)."""
    from PIL import Image

    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.ops import attention as ta
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam_vit_b
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.scripts import quality_distill_miou as qm
    from samnerf_tpu_torch.scripts import validate_zoo
    from samnerf_tpu_torch.scripts.quality_capacity import train_and_eval
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene = write_textured_scene(root / "miou_scene", num_train=24, num_test=4, h=256, w=256,
                                 with_features=True, detail=4.0)
    scene_s = time.perf_counter() - t0
    digests = scene_digests(scene)
    same = {k: digests[k] == SCENE_DIGESTS[k] for k in digests}
    print(f"quality scene: 24 + 4 views of 256x256 in {scene_s:.1f} s; first image PNG "
          f"sha256 {digests['png_sha256']}, pixels {digests['pixels_sha256']}, .npy "
          f"{digests['npy_sha256']}; equal to the JAX package's: {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"the textured scene differs from the JAX package's: {digests}")

    # the ViT-B targets
    ta.flash_attention_relpos.launches = 0
    sam, target_ms = qm.make_vit_features(scene, seed=0, device=dev)
    target_launches = ta.flash_attention_relpos.launches
    images = len(target_ms)
    if target_launches != 4 * images:
        raise AssertionError(f"FLASH-RELPOS launched {target_launches} times for {images} "
                             f"ViT-B images, not 4 per image")
    img0 = np.asarray(Image.open(scene / "images" / "frame_00000.png"))
    plain = build_sam_vit_b(device="meta")
    plain.load_state_dict(sam.state_dict(), assign=True)
    for block in plain.image_encoder.blocks:
        block.attn.use_flash = False
    plain_predictor = SamPredictor(plain)
    plain_predictor.set_image(img0)
    if ta.flash_attention_relpos.launches != target_launches:
        raise AssertionError("the plain route launched FLASH-RELPOS")
    kernel_emb = np.moveaxis(np.load(scene / "sam_features" / "frame_00000.npy"), 0, -1)
    plain_emb = plain_predictor.get_image_embedding()[0].cpu().numpy()
    route_err = float(np.abs(kernel_emb - plain_emb).max())
    del plain, plain_predictor
    target_image_ms = statistics.median(target_ms[1:])     # the first is the warm-up
    print(f"quality targets: ViT-B on {images} images, median {target_image_ms:.2f} ms per "
          f"image after the first ({target_ms[0]:.1f}); FLASH-RELPOS launches "
          f"{target_launches} ({target_launches / images:g} per image); kernel vs plain "
          f"route embedding max abs err {route_err:.3e} (tol {TOL_ENCODE:g}, |emb| max "
          f"{np.abs(kernel_emb).max():.2f})", flush=True)
    if not route_err <= TOL_ENCODE:
        raise AssertionError(f"the ViT-B targets' kernel and plain routes disagree: {route_err}")

    # the training at reference capacity
    # the wrappers count what Python launched: the first block eagerly and
    # into its graph; the replays launch nothing from Python (what a replay
    # runs on the card: dispatch_train, the same path untimed here, since a
    # trace in the loop would be inside train_and_eval's timing)
    counts = {}

    def on_step(step, metrics):
        if step == QUALITY_STEPS:
            counts.update(_encode_launches(), **{
                "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches})

    print(f"quality train: {QUALITY_STEPS} of the study's 3000 steps (cut to fit the phase)",
          flush=True)
    _reset_encode_launches()
    m, trainer = train_and_eval(scene, *QUALITY_TABLES, QUALITY_STEPS, QUALITY_RAYS,
                                args_views=24, hash_fn="morton", return_trainer=True,
                                persist_run=False, device=dev, step_callback=on_step)
    eval_f32 = hg.parity_hash_encode.launches - counts["F32-ENC"]
    dispatched = trainer.steps_by_dispatch
    ran = dispatched["eager"] + dispatched["captured"]
    replayed = QUALITY_STEPS - DISPATCH_BLOCK
    per_step = {k: counts[k] / ran for k in ("F32-ENC", "F32-ENC-BWD")}
    print(f"quality train 2^{QUALITY_TABLES[0]} / 2^{QUALITY_TABLES[1]} morton, "
          f"{QUALITY_RAYS} rays: {m['step_ms']:.2f} ms a "
          f"step after the first block, {QUALITY_RAYS / m['step_ms'] * 1e3:,.0f} rays/s "
          f"({m['train_s']} s with set-up; {dispatched}); launched F32-ENC "
          f"{counts['F32-ENC']}, F32-ENC-BWD {counts['F32-ENC-BWD']} in the {ran} steps run "
          f"eagerly or captured; test PSNR {m['psnr']:.2f}, SSIM "
          f"{m['ssim']:.4f}, train PSNR {m['train_psnr']:.2f}, SAM-feature MSE "
          f"{m['sam_feature_mse']:.4f}, cosine {m['sam_feature_cos']:.4f}; F32-ENC "
          f"{eval_f32} in the metrics' renders", flush=True)
    if per_step != {"F32-ENC": F32_PER_STEP, "F32-ENC-BWD": F32_PER_STEP} \
            or counts["Q-ENC"] or dispatched["replayed"] != replayed:
        raise AssertionError(f"the quality run ({dispatched}) launched {counts}")
    for k in ("psnr", "ssim", "train_psnr", "sam_feature_mse", "sam_feature_cos", "step_ms"):
        if not math.isfinite(m[k]):
            raise AssertionError(f"quality metric {k} is {m[k]}")

    # the closed loop on one held-out view
    test_paths = qm.gt_paths(scene, "transforms_test.json")
    cams = trainer.datamanager.eval_cameras.to(dev)
    ta.flash_attention_relpos.launches = 0
    t0 = time.perf_counter()
    v, v_gt = qm.view_miou(ImageRenderer(trainer.model), cams, 0, sam, QUALITY_GRID,
                           gt_path=test_paths[0])
    miou_s = time.perf_counter() - t0
    miou_launches = ta.flash_attention_relpos.launches
    print(f"quality mIoU held-out view 0, {QUALITY_GRID}x{QUALITY_GRID} prompts: vs "
          f"set_image(rendered rgb) {v:.4f}, vs set_image(GT) {v_gt:.4f} ({miou_s:.1f} s, "
          f"{miou_launches} FLASH-RELPOS)", flush=True)
    if not (0.0 <= v <= 1.0 and 0.0 <= v_gt <= 1.0) or miou_launches != 8:
        raise AssertionError(f"mIoU {v}, {v_gt}; FLASH-RELPOS {miou_launches}, not 2 x 4")
    del trainer, sam
    torch.cuda.empty_cache()

    # one zoo method through validate_zoo's runner
    zoo_scene = write_textured_scene(root / "zoo_scene", num_train=24, num_test=2,
                                     h=QUALITY_ZOO_SIZE, w=QUALITY_ZOO_SIZE, detail=2.0)
    base = validate_zoo.trivial_psnr(zoo_scene)
    p, zoo_s, tail = validate_zoo.run_method("instant-ngp", zoo_scene, QUALITY_ZOO_STEPS,
                                             ZOO_RAYS, root / "zoo_runs")
    if p is None or not math.isfinite(p):
        raise AssertionError("validate_zoo instant-ngp failed:\n" + "\n".join(tail))
    print(f"quality zoo: instant-ngp {QUALITY_ZOO_STEPS} steps x {ZOO_RAYS} rays at "
          f"{QUALITY_ZOO_SIZE}x{QUALITY_ZOO_SIZE}, eval PSNR {p:.2f} against the trivial "
          f"{base:.2f} ({p - base:+.2f} dB), {zoo_s:.1f} s in its own process", flush=True)
    dn = zoo_depth_check(root, dev)
    phase_s = time.perf_counter() - t_phase
    print(f"quality phase: {phase_s:.1f} s", flush=True)
    return dict(scene_s=scene_s, digests=digests, digests_equal=same,
                target_ms=target_ms, target_image_ms=target_image_ms,
                target_launches=target_launches, route_max_abs_err=route_err,
                steps=QUALITY_STEPS, rays=QUALITY_RAYS, metrics=m,
                launches={"F32-ENC": counts["F32-ENC"], "F32-ENC-BWD": counts["F32-ENC-BWD"]},
                steps_by_dispatch=dict(dispatched),
                launches_per_step=per_step, eval_f32_enc=eval_f32,
                miou=dict(grid=QUALITY_GRID, vs_render=v, vs_gt=v_gt, seconds=miou_s,
                          flash_launches=miou_launches),
                zoo=dict(method="instant-ngp", steps=QUALITY_ZOO_STEPS, psnr=p,
                         trivial_psnr=base, margin=p - base, seconds=zoo_s),
                zoo_depth=dn, seconds=phase_s)


def zoo_depth_check(root: Path, dev) -> dict:
    """depth-nerfacto through ``validate_zoo.run_method`` (its own process)
    on ``validate_zoo --views 64``'s scene for ``QUALITY_DN_STEPS`` steps of
    ``ZOO_RAYS`` rays at seed ``QUALITY_DN_SEED``: its eval PSNR must clear
    the constant colour by ``QUALITY_DN_MARGIN``; its F32-ENC and
    F32-ENC-BWD launches (the train entry's last line) must be 2 a step,
    and 2 per 4096-ray eval chunk for F32-ENC.

    The seed is chosen: on some seeds the zoo loop loses every hidden unit
    of the proposal MLP in its first steps and never trains, in the JAX
    package as in the port (ROADMAP Queue C (x); the port's seeds 42, 1
    and 2 on this scene, JAX's seed 1).  Seed 3 is the first of the port's
    seeds 3-7 that all train there (21.1-21.3 dB at 2000 steps on an
    H100), so this checks that the path trains, not that every seed does.
    The proposal MLP's dead hidden units (those that no sample of eval
    view 0 activates) are reported beside the PSNR: 16 of 16 is that
    collapse."""
    from samnerf_tpu_torch.scripts import validate_zoo
    from samnerf_tpu_torch.train import EVAL_CHUNK
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    scene = write_textured_scene(root / "zoo_scene_64", num_train=QUALITY_DN_VIEWS,
                                 num_test=2, h=QUALITY_ZOO_SIZE, w=QUALITY_ZOO_SIZE,
                                 detail=2.0)
    base = validate_zoo.trivial_psnr(scene)
    p, seconds, tail = validate_zoo.run_method("depth-nerfacto", scene, QUALITY_DN_STEPS,
                                               ZOO_RAYS, root / "zoo_runs",
                                               seed=QUALITY_DN_SEED)
    found = [LAUNCH_LINE.search(line) for line in tail]
    counts = next((tuple(int(x) for x in m.groups()) for m in found if m), None)
    saved = next((m.group(1) for m in map(SAVED_LINE.search, tail) if m), None)
    if p is None or counts is None or saved is None:
        raise AssertionError("validate_zoo depth-nerfacto failed:\n" + "\n".join(tail))
    dead, units = dead_proposal_units(Path(saved), scene, QUALITY_DN_STEPS, dev)
    chunks = -(-QUALITY_ZOO_SIZE ** 2 // EVAL_CHUNK)
    want = (2 * QUALITY_DN_STEPS + 2 * chunks, 2 * QUALITY_DN_STEPS)
    print(f"quality zoo: depth-nerfacto {QUALITY_DN_STEPS} steps x {ZOO_RAYS} rays on "
          f"{QUALITY_DN_VIEWS} + 2 views of {QUALITY_ZOO_SIZE}x{QUALITY_ZOO_SIZE}, seed "
          f"{QUALITY_DN_SEED}, eval PSNR {p:.2f} against the trivial {base:.2f} "
          f"({p - base:+.2f} dB, at least {QUALITY_DN_MARGIN:g}), proposal MLP {dead} of "
          f"{units} hidden units dead, F32-ENC {counts[0]} and F32-ENC-BWD {counts[1]} "
          f"launches (expected {want[0]} and {want[1]}), {seconds:.1f} s in its own process",
          flush=True)
    if not (math.isfinite(p) and p - base >= QUALITY_DN_MARGIN) or counts != want:
        raise AssertionError(f"depth-nerfacto: PSNR {p:.2f} against the trivial {base:.2f}, "
                             f"{dead} of {units} proposal units dead, launches {counts} "
                             f"(expected {want})")
    return dict(method="depth-nerfacto", views=QUALITY_DN_VIEWS, steps=QUALITY_DN_STEPS,
                seed=QUALITY_DN_SEED, psnr=p, trivial_psnr=base, margin=p - base,
                proposal_dead_units=dead, proposal_units=units, seconds=seconds,
                launches={"F32-ENC": counts[0], "F32-ENC-BWD": counts[1]})


def dead_proposal_units(run_dir: Path, scene: Path, steps: int, dev):
    """(dead, all) hidden units of the first layer of the proposal MLP of a
    depth-nerfacto run's checkpoint: a unit is dead when its
    pre-activation is <= 0 at every proposal sample of eval view 0."""
    from samnerf_tpu_torch.configs.zoo import zoo_methods
    from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR
    from samnerf_tpu_torch.train import render_eval_rgb

    model, _ = zoo_methods()["depth-nerfacto"].build(device=dev)
    state = torch.load(run_dir / CKPT_DIR / f"step-{steps:09d}.pt", map_location=dev)
    model.load_state_dict(state["model"])
    first = model.proposal_networks[0].mlp.layers[0]
    alive = torch.zeros(first.out_features, dtype=torch.bool, device=dev)

    def hook(mlp, args, out):
        pre = torch.nn.functional.linear(args[0].float(), first.weight, first.bias)
        alive.logical_or_(pre.reshape(-1, pre.shape[-1]).gt(0).any(0))

    cameras = DataManager(DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True))).eval_cameras.to(dev)
    handle = model.proposal_networks[0].mlp.register_forward_hook(hook)
    try:
        with torch.no_grad():
            render_eval_rgb(model, cameras, 0)
    finally:
        handle.remove()
    return int((~alive).sum()), int(alive.numel())


EXPORT_MODES = ("pointcloud", "tsdf", "poisson")
EXPORT_VIEWS, EXPORT_SIZE, EXPORT_RES = 8, 256, 128   # the exporter's defaults
# TSDF card vs CPU: the world-to-camera matmul sums in another order, so a
# voxel whose projection lies within float noise of a pixel edge reads the
# neighbouring pixel; all but this share of voxels agree to 1e-5
TOL_TSDF_SHARE = 1e-3
TOL_POISSON = 1e-3              # chi after 200 CG steps, relative to its max norm
POSE_CAMERAS, POSE_RAYS = 8, 16384
POSE_GRAD_RAYS = 4096
TOL_RAY = 1e-5                  # unit directions and origins, card vs CPU
# the pose gradient sums over every ray with cancellation: rtol 2e-3 and 1 %
# of the largest component (tests/test_torch_pose.py's tolerance)
TOL_POSE_GRAD_RTOL, TOL_POSE_GRAD_MAX_SHARE = 2e-3, 1e-2
DIST_WARMUP, DIST_STEPS, ALLREDUCE_STEPS = 2, 8, 3
TORCHRUN_SCENE_SIZE = 128
SHARDED_FRAMES = 3              # timed sharded frames after a warm-up
DECODER_CALLS = 20              # timed calls of the exported decoder and decode_masks
TOL_DECODER = 1e-5
BENCH_SCENE_SIZE, BENCH_STEPS = 128, 3
SDS_STEPS = 50
TOL_SDS = 1e-5


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _obj_counts(path: Path):
    v = f = 0
    with open(path) as fh:
        for line in fh:
            v += line.startswith("v ")
            f += line.startswith("f ")
    return v, f


def export_phase(dev, run_dir: Path, root: Path):
    """``scripts/exporter.py``'s ``main`` on the eval phase's full-width run
    directory in each mode at its defaults (8 views of 256x256, TSDF and
    Poisson at 128^3, box half-side 1.5): ms, points / vertices / faces,
    peak memory, F32-ENC launches per view against the renderer's chunking;
    then TSDF integration and the Poisson indicator of two rendered views
    on the card against the same inputs on the CPU."""
    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.exporter import exporter as ex
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.scripts import exporter as export_script
    from samnerf_tpu_torch.scripts.render import orbit_c2w
    from samnerf_tpu_torch.utils.eval_utils import eval_setup

    cfg = train_entry.parse(["samnerf_distill"]).model
    # the exporter's ImageRenderer chunks at its default
    chunk = inspect.signature(ImageRenderer).parameters["chunk"].default
    per_view = math.ceil(EXPORT_SIZE ** 2 / chunk) * (cfg.num_proposal_iterations + 1)
    modes = {}
    for mode in EXPORT_MODES:
        out = root / f"export_{mode}.{'ply' if mode == 'pointcloud' else 'obj'}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_encode_launches()
        t0 = time.perf_counter()
        rc = export_script.main([mode, str(run_dir), "--output", str(out)], device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _encode_launches()
        if rc != 0:
            raise AssertionError(f"the exporter's {mode} mode returned {rc}")
        if mode == "pointcloud":
            header = out.read_bytes().split(b"end_header\n", 1)[0].decode()
            counts = {"points": int(header.split("element vertex ")[1].split()[0])}
        else:
            v, f = _obj_counts(out)
            counts = {"vertices": v, "faces": f}
            if not 2 * f <= v <= 3 * f:
                raise AssertionError(f"the {mode} mesh has {v} vertices for {f} faces")
        if not any(counts.values()):
            raise AssertionError(f"the exporter's {mode} output is empty: {counts}")
        if launches != {"F32-ENC": per_view * EXPORT_VIEWS, "Q-ENC": 0, "FUSED-QMLP": 0}:
            raise AssertionError(f"the exporter's {mode} mode launched {launches}, not "
                                 f"{per_view} F32-ENC per view")
        modes[mode] = dict(ms=ms, **counts, launches=launches,
                           launches_per_view=launches["F32-ENC"] / EXPORT_VIEWS,
                           max_memory_allocated=torch.cuda.max_memory_allocated(),
                           bytes=out.stat().st_size)
        print(f"export {mode}: {ms:.0f} ms for {EXPORT_VIEWS} views of {EXPORT_SIZE}x"
              f"{EXPORT_SIZE}{'' if mode == 'pointcloud' else f' at {EXPORT_RES}^3'}; "
              f"{counts}; F32-ENC launches/view {modes[mode]['launches_per_view']:g} "
              f"(renderer chunking: {per_view}); max_memory_allocated="
              f"{modes[mode]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)

    # TSDF and Poisson on the card against the CPU, on two rendered views
    trainer, _ = eval_setup(run_dir, device=dev)
    renderer = ImageRenderer(trainer.model)
    focal = 0.5 * EXPORT_SIZE / np.tan(np.deg2rad(30.0))
    intrin = np.array([[focal, 0, EXPORT_SIZE / 2], [0, focal, EXPORT_SIZE / 2], [0, 0, 1]])
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    views = []
    for i in range(2):
        c2w = orbit_c2w(2 * np.pi * i / EXPORT_VIEWS, 1.5)
        cams = Cameras(camera_to_worlds=torch.as_tensor(c2w[None], dtype=torch.float32,
                                                        device=dev),
                       **{k: torch.tensor([[v]], dtype=torch.float32, device=dev)
                          for k, v in (("fx", focal), ("fy", focal), ("cx", EXPORT_SIZE / 2),
                                       ("cy", EXPORT_SIZE / 2))},
                       width=EXPORT_SIZE, height=EXPORT_SIZE)
        views.append((renderer.render_image(cams, 0), c2w))
    del trainer, renderer
    states = {}
    tsdf_ms = {}
    for d in (dev, torch.device("cpu")):
        state = ex.tsdf_init(EXPORT_RES, device=d)
        t0 = time.perf_counter()
        for out, c2w in views:
            state = ex.tsdf_integrate(
                state, torch.as_tensor(out["depth"][..., 0], device=d),
                torch.as_tensor(out["rgb"], device=d),
                torch.as_tensor(intrin, dtype=torch.float32, device=d),
                torch.as_tensor(c2w, dtype=torch.float32, device=d),
                torch.as_tensor(aabb, device=d))
        if d.type == "cuda":
            torch.cuda.synchronize()
        tsdf_ms[d.type] = (time.perf_counter() - t0) * 1e3
        states[d.type] = [t.cpu() for t in state]
    tsdf_share = max(
        float(((a - b).abs() > 1e-5).reshape(EXPORT_RES ** 3, -1).any(-1).float().mean())
        for a, b in zip(states["cuda" if dev.type == "cuda" else "cpu"], states["cpu"]))
    pts, nrms = zip(*(ex.depth_to_oriented_points(out["depth"], out["accumulation"], intrin,
                                                  c2w, min_accumulation=0.5)
                      for out, c2w in views))
    pts, nrms = np.concatenate(pts), np.concatenate(nrms)
    chis, poisson_ms = {}, {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        chis[d.type] = ex.poisson_indicator(pts, nrms, aabb, EXPORT_RES, device=d).cpu()
        poisson_ms[d.type] = (time.perf_counter() - t0) * 1e3
    card = chis["cuda" if dev.type == "cuda" else "cpu"]
    scale = float(chis["cpu"].abs().max())
    poisson_err = float((card - chis["cpu"]).abs().max()) / max(scale, 1e-30)
    result = dict(modes=modes, per_view=per_view, views=EXPORT_VIEWS, size=EXPORT_SIZE,
                  resolution=EXPORT_RES, tsdf_ms=tsdf_ms, tsdf_mismatch_share=tsdf_share,
                  tsdf_weight_sum=float(states["cpu"][1].sum()), poisson_ms=poisson_ms,
                  poisson_points=int(len(pts)), poisson_rel_err=poisson_err)
    print(f"export reference: TSDF {EXPORT_RES}^3 of 2 views card {tsdf_ms.get('cuda', 0):.1f}"
          f" ms vs CPU {tsdf_ms['cpu']:.1f} ms, voxels beyond 1e-5 {tsdf_share:.2e} (tol "
          f"{TOL_TSDF_SHARE:g}); Poisson {EXPORT_RES}^3 from {len(pts)} points, 200 CG "
          f"steps, card {poisson_ms.get('cuda', 0):.0f} ms vs CPU {poisson_ms['cpu']:.0f} ms, "
          f"chi rel err {poisson_err:.2e} (tol {TOL_POISSON:g})", flush=True)
    if tsdf_share > TOL_TSDF_SHARE or result["tsdf_weight_sum"] <= 0:
        raise AssertionError(f"TSDF card vs CPU: {tsdf_share} of voxels differ")
    if not math.isfinite(poisson_err) or poisson_err > TOL_POISSON or scale == 0:
        raise AssertionError(f"Poisson chi card vs CPU: rel err {poisson_err}")
    return result


def _pose_cameras(d, n=POSE_CAMERAS, size=512, focal=400.0):
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.utils.synthetic import look_at_c2w

    c2w = np.stack([look_at_c2w(np.array([1.5 * np.cos(a), 1.5 * np.sin(a), 0.4]),
                                np.zeros(3))[:3]
                    for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]).astype(np.float32)

    def col(v):
        return torch.full((n, 1), float(v), device=d)

    return Cameras(camera_to_worlds=torch.as_tensor(c2w, device=d), fx=col(focal),
                   fy=col(focal), cx=col(size / 2), cy=col(size / 2), width=size, height=size)


def pose_phase(dev):
    """``generate_rays`` with SO3xR3 and SE3 deltas of a ``CameraOptimizer``
    for a 16384-ray batch, card against CPU; the SE3 gradient at the zero
    initialisation finite on the card; the gradient of a small model's
    rgb loss with respect to SO3xR3 ``pose_adjustment`` (F32-ENC forward,
    F32-ENC-BWD backward on the card), card against CPU."""
    from samnerf_tpu_torch.core.camera_optimizers import CameraOptimizer
    from samnerf_tpu_torch.core.cameras import generate_rays
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.utils.init import init_state

    rng = np.random.default_rng(12)
    idx = rng.integers(0, POSE_CAMERAS, POSE_RAYS)
    coords = rng.integers(0, 512, (POSE_RAYS, 2)).astype(np.float32)
    adj = (rng.normal(size=(POSE_CAMERAS, 6)) * 0.02).astype(np.float32)
    rays = {}
    for mode in ("SO3xR3", "SE3"):
        out = {}
        for d in (dev, torch.device("cpu")):
            opt = CameraOptimizer(POSE_CAMERAS, mode, device=d)
            with torch.no_grad():
                opt.pose_adjustment.copy_(torch.from_numpy(adj))
            ci = torch.as_tensor(idx, device=d)
            rb = generate_rays(_pose_cameras(d), ci, torch.as_tensor(coords, device=d),
                               camera_opt_to_camera=opt(ci))
            out[d.type] = (rb.origins.detach().cpu(), rb.directions.detach().cpu())
        card = out["cuda" if dev.type == "cuda" else "cpu"]
        err = max(float((a - b).abs().max()) for a, b in zip(card, out["cpu"]))
        rays[mode] = err
        if not err <= TOL_RAY:
            raise AssertionError(f"{mode} rays card vs CPU differ by {err}")
    opt = CameraOptimizer(POSE_CAMERAS, "SE3", device=dev)
    ci = torch.as_tensor(idx, device=dev)
    generate_rays(_pose_cameras(dev), ci, torch.as_tensor(coords, device=dev),
                  camera_opt_to_camera=opt(ci)).directions.sum().backward()
    se3_zero_finite = bool(torch.isfinite(opt.pose_adjustment.grad).all())
    if not se3_zero_finite:
        raise AssertionError("the SE3 pose gradient at zero is not finite")

    cfg = dataclasses.replace(SAMModelConfig(**SMALL_MODEL), distill_sam=False)
    gi = rng.integers(0, POSE_CAMERAS, POSE_GRAD_RAYS)
    gc = rng.integers(0, 512, (POSE_GRAD_RAYS, 2)).astype(np.float32)
    target = rng.uniform(size=(POSE_GRAD_RAYS, 3)).astype(np.float32)
    grads, launches = {}, None
    for d in (dev, torch.device("cpu")):
        model = SAMModel(cfg, device=d)
        model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                         torch.Generator().manual_seed(1), device=d,
                                         table_scale=0.5))
        opt = CameraOptimizer(POSE_CAMERAS, "SO3xR3", device=d)
        with torch.no_grad():
            opt.pose_adjustment.copy_(torch.from_numpy(adj))
        ci = torch.as_tensor(gi, device=d)
        _reset_encode_launches()
        rb = generate_rays(_pose_cameras(d), ci, torch.as_tensor(gc, device=d),
                           camera_opt_to_camera=opt(ci))
        loss = torch.mean((model(rb, train=True)["rgb"] - torch.as_tensor(target, device=d))
                          ** 2)
        loss.backward()
        grads[d.type] = opt.pose_adjustment.grad.cpu()
        if d.type == dev.type:
            launches = {"F32-ENC": hg.parity_hash_encode.launches,
                        "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches}
    card, cpu = grads["cuda" if dev.type == "cuda" else "cpu"], grads["cpu"]
    atol = TOL_POSE_GRAD_MAX_SHARE * float(cpu.abs().max())
    excess = float(((card - cpu).abs() - TOL_POSE_GRAD_RTOL * cpu.abs()).max())
    result = dict(rays=POSE_RAYS, ray_max_abs_err=rays, se3_zero_grad_finite=se3_zero_finite,
                  grad_rays=POSE_GRAD_RAYS, grad_max_abs=float(cpu.abs().max()),
                  grad_max_abs_err=float((card - cpu).abs().max()), grad_atol=atol,
                  launches=launches)
    print(f"pose: {POSE_RAYS} rays with SO3xR3 / SE3 deltas card vs CPU max abs err "
          f"{rays['SO3xR3']:.2e} / {rays['SE3']:.2e} (tol {TOL_RAY:g}); SE3 gradient at "
          f"zero finite; pose gradient of a small model's rgb loss ({POSE_GRAD_RAYS} rays) "
          f"card vs CPU max abs err {result['grad_max_abs_err']:.2e} (largest "
          f"{result['grad_max_abs']:.2e}, atol {atol:.2e}, rtol {TOL_POSE_GRAD_RTOL:g}); "
          f"launches {launches}", flush=True)
    if not math.isfinite(excess) or excess > atol or not float(cpu.abs().max()) > 0:
        raise AssertionError(f"pose gradients card vs CPU: {result}")
    if dev.type == "cuda" and not (launches["F32-ENC"] and launches["F32-ENC-BWD"]):
        raise AssertionError(f"the pose gradient ran {launches}")
    return result


def sharded_frame_check(dev, size=VIEW_SIZE, cfg=None):
    """``build_sharded_frame_fn`` with baked int8 fused tables and a click
    on the process group that is up, against ``serve_frame_fn``'s frame:
    ms per frame, FUSED-QMLP launches per frame, the overlay's difference
    (bit for bit at one rank: the same chunking)."""
    from samnerf_tpu_torch.engine.eval_render import build_sharded_frame_fn
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.parallel import mesh
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    H = W = size
    cfg = dataclasses.replace(cfg or SAMModelConfig(hash_fn="morton"), hash_q8_serve=True,
                              serve_fuse_mlp=True)
    gen = torch.Generator().manual_seed(0)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_params(cfg, gen, device=dev))
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    snr = SamNerfRenderer(model, serve_preset="static")
    snr.bake_serve_tables()
    serve = snr.serve_frame_fn(sam, H, W)
    frame = build_sharded_frame_fn(snr.renderer, H, W, ("sam", "clipseg"), sam=sam)
    click = (100.0, 300.0)
    coords = torch.zeros((1, 4, 2), device=dev)
    coords[0, 0] = torch.tensor([c * 1024.0 / max(H, W) for c in click])
    labels = torch.full((1, 4), -1, dtype=torch.int32, device=dev)
    labels[0, 0] = 1
    cams = _cameras(dev, 1, H, W, 400.0)
    frame(cams, 0, coords, labels)                               # warm-up
    torch.cuda.synchronize()
    _reset_encode_launches()
    times = []
    for _ in range(SHARDED_FRAMES):
        t0 = time.perf_counter()
        out = frame(cams, 0, coords, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _encode_launches()
    mine = (torch.clamp(out["masked_rgb"], 0.0, 1.0) * 255.0).to(torch.uint8)
    ref = serve(cams, 0, click)
    diff = int((mine.int() - ref.int()).abs().max())
    grid_ref = snr.renderer.render_image_device(cams, 0, W, H, ("sam", "clipseg"),
                                                minimal=True)
    grid_err = max(float((out[k] - grid_ref[k]).abs().max()) for k in ("rgb", "sam", "clipseg"))
    result = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                  frames=SHARDED_FRAMES, launches=launches,
                  launches_per_frame=launches["FUSED-QMLP"] / SHARDED_FRAMES,
                  overlay_max_diff=diff, bits_equal=diff == 0 and grid_err == 0.0,
                  grid_max_abs_err=grid_err)
    print(f"sharded frame {H}x{W} int8 fused, {mesh.world_size()} rank(s): median "
          f"{result['frame_ms']:.2f} ms over {SHARDED_FRAMES}; launches/frame "
          + " ".join(f"{k}={v / SHARDED_FRAMES:g}" for k, v in launches.items())
          + f"; overlay vs serve_frame_fn max diff {diff}, grids max abs err {grid_err:.2e}",
          flush=True)
    if launches != {"F32-ENC": 0, "Q-ENC": 0, "FUSED-QMLP": FUSED_PER_FRAME * SHARDED_FRAMES}:
        raise AssertionError(f"the sharded frame launched {launches}, not "
                             f"{FUSED_PER_FRAME} FUSED-QMLP per frame")
    if diff > 255 * TOL_FRAME or grid_err > TOL_FRAME:
        raise AssertionError(f"the sharded frame differs from serve_frame_fn's: {result}")
    return result


def dist_phase(dev, scene: Path, root: Path, train_step_ms: float):
    """A process group of one rank (NCCL on the card, at a free local TCP
    port, destroyed afterwards): full-width data-parallel ``Trainer`` steps
    on ``scene`` (ms per step beside the train phase's, 6 + 6 launches per
    step, the gradient all-reduce's ms); the sharded 512x512 frame;
    then ``torchrun --standalone --nproc-per-node 1 -m
    samnerf_tpu_torch.train samnerf_distill`` for 3 steps on a small
    scene."""
    import os

    import torch.distributed as dist

    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.parallel import mesh
    from samnerf_tpu_torch.scripts.profile_train import build_trainer
    from samnerf_tpu_torch.utils.synthetic import write_scene

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        trainer = build_trainer(scene, root / "dist_out", dev)
        if not trainer.distributed:
            raise AssertionError("the Trainer did not take the data-parallel path")
        times, losses, t_prev = [], [], [0.0]

        def on_step(step, metrics):
            losses.append({k: float(v) for k, v in metrics.items()})
            torch.cuda.synchronize()
            now = time.perf_counter()
            if step == DIST_WARMUP:
                _reset_encode_launches()
            elif step > DIST_WARMUP:
                times.append((now - t_prev[0]) * 1e3)
            t_prev[0] = now

        trainer.cfg.max_num_iterations = DIST_WARMUP + DIST_STEPS
        trainer.train(step_callback=on_step)
        launches = {"F32-ENC": hg.parity_hash_encode.launches,
                    "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                    "Q-ENC": hg.parity_hash_encode_q8.launches}
        all_reduce = mesh.all_reduce_grads
        ar_ms = []

        def timed_all_reduce(params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(params)
            torch.cuda.synchronize()
            ar_ms.append((time.perf_counter() - t0) * 1e3)

        mesh.all_reduce_grads = timed_all_reduce
        try:
            for i in range(ALLREDUCE_STEPS):
                trainer.train_iteration(DIST_WARMUP + DIST_STEPS + i)
        finally:
            mesh.all_reduce_grads = all_reduce
        grad_bytes = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
        del trainer
        step_ms = statistics.median(times)
        print(f"dist {backend} world size 1: data-parallel samnerf_distill step median "
              f"{step_ms:.2f} ms over {DIST_STEPS} (the train phase's {train_step_ms:.2f} ms); "
              f"gradient all-reduce median {statistics.median(ar_ms):.2f} ms for "
              f"{grad_bytes / 2**20:.0f} MiB; launches/step "
              + ", ".join(f"{k}={v / DIST_STEPS:g}" for k, v in launches.items()), flush=True)
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"data-parallel losses {losses}")
        if launches != {"F32-ENC": F32_PER_STEP * DIST_STEPS,
                        "F32-ENC-BWD": F32_PER_STEP * DIST_STEPS, "Q-ENC": 0}:
            raise AssertionError(f"the data-parallel step launched {launches} in "
                                 f"{DIST_STEPS} steps")
        frame = sharded_frame_check(dev)
    finally:
        dist.destroy_process_group()

    # the entry point under torchrun (one process: the group stays down), on
    # a small scene: the call's time is the process's start
    small_scene = write_scene(root / "torchrun_scene", num_train=4, num_test=1,
                              h=TORCHRUN_SCENE_SIZE, w=TORCHRUN_SCENE_SIZE,
                              with_features=True, feature_long_side=64)
    out = root / "torchrun_out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "samnerf_tpu_torch.train", "samnerf_distill",
           "--data", str(small_scene), "--vis", "json", "--trainer.max-num-iterations", "3",
           "--trainer.output-dir", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})
    torchrun_s = time.perf_counter() - t0
    ckpts = sorted(out.glob("*/samnerf_distill/*/samnerf_tpu_torch_ckpts/step-000000003.pt"))
    print(f"dist torchrun --nproc-per-node 1 train 3 steps: rc {proc.returncode} in "
          f"{torchrun_s:.1f} s; checkpoint {[c.name for c in ckpts]}", flush=True)
    if proc.returncode != 0 or len(ckpts) != 1:
        raise AssertionError(f"torchrun train failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(backend=backend, world_size=1, step_ms=step_ms, step_ms_all=times,
                train_phase_step_ms=train_step_ms, steps=DIST_STEPS, launches=launches,
                launches_per_step={k: v / DIST_STEPS for k, v in launches.items()},
                all_reduce_ms=statistics.median(ar_ms), all_reduce_ms_all=ar_ms,
                grad_bytes=grad_bytes, last_losses=losses[-1], sharded_frame=frame,
                torchrun_s=torchrun_s, torchrun_tail=proc.stdout[-1000:])


def tools_phase(dev, root: Path):
    """The SAM decoder export at full width (``torch.export`` save, load,
    run: ms per call against ``decode_masks``, the masks held against it),
    ``scripts/benchmark.py``'s ``main`` over two copies of a synthetic
    scene, a ``DeviceTrace``, the SDS DDIM loop and gradient on the card
    against the CPU, and the native image decoder (built or PIL) against
    PIL's bytes."""
    import shutil

    from PIL import Image

    from samnerf_tpu_torch import native
    from samnerf_tpu_torch.generative import stable_diffusion as sd
    from samnerf_tpu_torch.perception.sam import export as sam_export
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.scripts import benchmark
    from samnerf_tpu_torch.utils.profiler import DeviceTrace
    from samnerf_tpu_torch.utils.synthetic import write_scene

    # the decoder export
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(3), device=dev))
    gen = torch.Generator().manual_seed(4)
    emb = torch.randn((1, 64, 64, 256), generator=gen).to(dev)
    coords = torch.zeros((1, 4, 2), device=dev)
    coords[0, :2] = torch.tensor([[300.0, 520.0], [610.0, 200.0]])
    labels = torch.tensor([[1, 0, -1, -1]], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    exp = sam_export.export_decoder(sam, num_points=4)
    path = root / "sam_decoder.pt2"
    sam_export.save_decoder(path, exp)
    decoder = sam_export.load_decoder(path)
    export_s = time.perf_counter() - t0
    with torch.no_grad():
        got = decoder(emb, coords, labels)
        ref = sam.decode_masks(emb, (coords, labels), multimask_output=False)
        export_ms = _time_ms(lambda: decoder(emb, coords, labels), DECODER_CALLS)
        decode_ms = _time_ms(lambda: sam.decode_masks(emb, (coords, labels),
                                                      multimask_output=False), DECODER_CALLS)
    dec_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"tools decoder export: {len(exp.artifact) / 2**20:.1f} MiB, exported and loaded "
          f"in {export_s:.1f} s; {export_ms:.3f} ms per call vs decode_masks {decode_ms:.3f} "
          f"ms; max abs err {dec_err:.2e} (tol {TOL_DECODER:g})", flush=True)
    if not dec_err <= TOL_DECODER:
        raise AssertionError(f"the exported decoder differs from decode_masks by {dec_err}")

    # the multi-scene benchmark driver
    scene_a = write_scene(root / "bench" / "scene_a", num_train=6, num_test=2,
                          h=BENCH_SCENE_SIZE, w=BENCH_SCENE_SIZE, with_features=True,
                          feature_long_side=64)
    scene_b = root / "bench" / "scene_b"
    shutil.copytree(scene_a, scene_b)
    bench_out = root / "bench" / "benchmark.json"
    t0 = time.perf_counter()
    rc = benchmark.main(["samnerf_distill", "--scenes", f"{scene_a},{scene_b}", "--output",
                         str(bench_out), "--trainer.max-num-iterations", str(BENCH_STEPS),
                         "--trainer.output-dir", str(root / "bench" / "runs")], device=dev)
    bench_s = time.perf_counter() - t0
    summary = json.loads(bench_out.read_text()) if rc == 0 else {}
    print(f"tools benchmark: rc {rc}, {BENCH_STEPS} steps on two {BENCH_SCENE_SIZE}^2 "
          f"scenes in {bench_s:.1f} s; {summary}", flush=True)
    if rc != 0 or set(summary.get("scenes", {})) != {"scene_a", "scene_b"} or not all(
            math.isfinite(m["psnr"]) for m in summary["scenes"].values()):
        raise AssertionError(f"scripts/benchmark.py: rc {rc}, {summary}")

    # a device trace
    a = torch.randn((2048, 2048), device=dev)
    with DeviceTrace(root / "trace") as trace:
        (a @ a).sum().item()
    events = json.loads(trace.path.read_text()).get("traceEvents", [])
    averages = trace.profile.key_averages()
    device_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                    for e in averages)
    print(f"tools DeviceTrace: {len(events)} events in {trace.path.name}, device time "
          f"{device_us:.0f} us", flush=True)
    if not events:
        raise AssertionError("the DeviceTrace wrote no events")

    # SDS on the card against the CPU (the analytic backbone)
    x0 = 0.7
    lat, sds_grad = {}, {}
    start = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(5))
    noise = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    for d in (dev, torch.device("cpu")):
        guide = sd.StableDiffusionGuidance(
            unet_fn=lambda z, t, e: (z - torch.sqrt(guide.alphas_cumprod[t]) * x0)
            / torch.sqrt(1.0 - guide.alphas_cumprod[t]),
            vae_encode_fn=lambda img: img[..., :4] * 2.0, vae_decode_fn=lambda z: z / 2.0,
            text_embed_fn=lambda p: torch.zeros((len(p), 2, 8), device=d),
            guidance_scale=7.5, device=str(d))
        emb_d = guide.get_text_embeds("a photo of a chair")
        lat[d.type] = guide.produce_latents(emb_d, 64, 64, SDS_STEPS,
                                            latents=start.to(d)).cpu()
        img = torch.full((1, 8, 8, 4), 0.2, device=d, requires_grad=True)
        guide.sds(emb_d, img, t=torch.tensor(500, device=d), noise=noise.to(d)).backward()
        sds_grad[d.type] = img.grad.cpu()
    key = "cuda" if dev.type == "cuda" else "cpu"
    sds_err = max(float((lat[key] - lat["cpu"]).abs().max()),
                  float((sds_grad[key] - sds_grad["cpu"]).abs().max()))
    recovered = float((lat[key] - x0).abs().max())
    print(f"tools SDS: {SDS_STEPS}-step guided DDIM and the SDS gradient card vs CPU max abs "
          f"err {sds_err:.2e} (tol {TOL_SDS:g}); latents within {recovered:.2e} of x0",
          flush=True)
    if not sds_err <= TOL_SDS or not recovered < 1e-3:
        raise AssertionError(f"SDS card vs CPU {sds_err}, x0 recovered to {recovered}")

    # the native decoder against PIL
    files = sorted((scene_a / "images").glob("*.png"))
    t0 = time.perf_counter()
    decoded = native.decode_images(files, BENCH_SCENE_SIZE, BENCH_SCENE_SIZE)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pil = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])
    pil_ms = (time.perf_counter() - t0) * 1e3
    route = "native" if decoded is not None else "PIL"
    build_error = native.build_error()
    same = decoded is None or bool(np.array_equal(decoded, pil))
    print(f"tools image decode: {route} ({native.get_loader()}); {len(files)} images "
          f"{native_ms:.1f} ms vs PIL {pil_ms:.1f} ms; bytes equal to PIL's: {same}"
          + (f"; native build: {build_error}" if build_error else ""), flush=True)
    if not same:
        raise AssertionError("the native decoder's bytes differ from PIL's")
    return dict(decoder_export=dict(artifact_bytes=len(exp.artifact), export_s=export_s,
                                    ms=export_ms, decode_masks_ms=decode_ms,
                                    max_abs_err=dec_err),
                benchmark=dict(rc=rc, seconds=bench_s, summary=summary),
                device_trace=dict(events=len(events), device_us=device_us),
                sds=dict(max_abs_err=sds_err, x0_err=recovered),
                image_decode=dict(route=route, build_error=build_error, native_ms=native_ms,
                                  pil_ms=pil_ms, images=len(files), bytes_equal=same))


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
    dispatch_serve = dispatch_serve_phase(dev)
    reference = reference_phase(dev)
    view = view_phase(dev)
    cull, fused_model = cull_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        viewer = viewer_phase(dev, fused_model, Path(tmp))
    del fused_model
    serve_bf16 = serve_bf16_phase(dev)
    train = train_phase(dev)
    dispatch_train = dispatch_train_phase(dev)
    train_reference = train_reference_phase(dev)
    with tempfile.TemporaryDirectory() as keep, tempfile.TemporaryDirectory() as tmp:
        evaluation = eval_phase(dev, root=Path(keep))
        dino, dino_scene = dino_phase(dev, Path(tmp), train["step_ms"])
        data = data_phase(dev, dino_scene, Path(tmp), train["step_ms"])
        zoo = zoo_phase(dev, dino_scene, Path(tmp))
        zoo_reference = zoo_reference_phase(dev)
        quality = quality_phase(dev, Path(tmp))
        export = export_phase(dev, Path(evaluation["run_dir"]), Path(tmp))
        pose = pose_phase(dev)
        dist = dist_phase(dev, dino_scene, Path(tmp), train["step_ms"])
        tools = tools_phase(dev, Path(tmp))
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
    # largest encode per launch of its main path; ``launches`` is the
    # wrapper's count on that path (a serve run for the forward kernels:
    # its first frame's eager run and capture, the replays launching none;
    # the timed eager train steps for the backward), ``launches_by_path``
    # every path's count (for the paths trained in the preset's blocks,
    # dino, data and viewer_train's backward, the kernel's runs on the card
    # in one traced block of replays, by name from a profiler trace), ``replay_on_card``
    # its runs on the card in one replayed frame or step of a graphed path
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
    for k, route in zip(kernels, ("f32", "int8")):
        k["replay_on_card"] = {
            f"serve_{route}_frame": serve[route]["replay_on_card"][k["name"]],
            f"dispatch_serve_{route}_frame":
                dispatch_serve[route]["launches_per_frame"][k["name"]]}
    kernels[0]["replay_on_card"]["dispatch_train_step"] = \
        dispatch_train["on_card_per_step"]["F32-ENC"]
    kernels[0]["launches_by_path"].update(cull_bake_f32=cull["bake"]["f32"]["launches"]["F32-ENC"],
                                          viewer_train=viewer_train["launches"]["F32-ENC"])
    kernels[1]["launches_by_path"].update(
        cull_bake_int8=cull["bake"]["int8_fused"]["launches"]["Q-ENC"],
        serve_appearance_int8=data["serve_appearance"]["int8"]["launches"]["Q-ENC"])
    data_train = {k: sum(r["launches"][k] for r in data["runs"].values())
                  for k in ("F32-ENC", "F32-ENC-BWD")}
    kernels[0]["launches_by_path"].update(train_dino=dino["launches"]["F32-ENC"],
                                          data_train=data_train["F32-ENC"],
                                          zoo_train=zoo["launches"]["F32-ENC"],
                                          quality_train=quality["launches"]["F32-ENC"],
                                          quality_zoo_depth=quality["zoo_depth"]["launches"]
                                          ["F32-ENC"])
    kernels[0]["launches_by_path"].update(
        **{f"export_{m}": r["launches"]["F32-ENC"] for m, r in export["modes"].items()},
        pose_grad=pose["launches"]["F32-ENC"], dist_train=dist["launches"]["F32-ENC"])
    f32_enc = kernels[0]
    f32_enc["max_abs_err"] = max(f32_enc["max_abs_err"],
                                 max(r["fwd_max_abs_err"] for r in train_rows
                                     if r["kernel"] == "F32-ENC-BWD"),
                                 zoo["kernel_hold"]["f32_enc_max_abs_err"])
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
                        "viewer": viewer["launches"]["FUSED-QMLP"],
                        "serve_appearance_int8_fused":
                            data["serve_appearance"]["int8_fused"]["launches"]["FUSED-QMLP"],
                        "sharded_frame": dist["sharded_frame"]["launches"]["FUSED-QMLP"]},
                    "replay_on_card": {
                        "serve_int8_fused_frame":
                            serve["int8_fused"]["replay_on_card"]["FUSED-QMLP"],
                        **{f"dispatch_serve_{r}_frame":
                           dispatch_serve[r]["launches_per_frame"]["FUSED-QMLP"]
                           for r in ("int8_fused", "culled")}},
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
                        "viewer_train": viewer_train["launches"]["F32-ENC-BWD"],
                        "train_dino": dino["launches"]["F32-ENC-BWD"],
                        "data_train": data_train["F32-ENC-BWD"],
                        "zoo_train": zoo["launches"]["F32-ENC-BWD"],
                        "quality_train": quality["launches"]["F32-ENC-BWD"],
                        "quality_zoo_depth": quality["zoo_depth"]["launches"]["F32-ENC-BWD"],
                        "pose_grad": pose["launches"]["F32-ENC-BWD"],
                        "dist_train": dist["launches"]["F32-ENC-BWD"]},
                    "replay_on_card": {"dispatch_train_step":
                                       dispatch_train["on_card_per_step"]["F32-ENC-BWD"]},
                    "max_abs_err": max(max(r["max_abs_err"] for r in bwd_rows),
                                       zoo["kernel_hold"]["f32_enc_bwd_max_abs_err"]),
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
                                         "view_no_distill": no_distill_view["launches"],
                                         "quality_targets": quality["target_launches"],
                                         "quality_miou": quality["miou"]["flash_launches"]},
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
         "dispatch_serve": dispatch_serve, "dispatch_train": dispatch_train,
         "view": view, "train": train,
         "train_reference": train_reference, "attn_kernel_rows": attn_rows,
         "encode": encode, "encode_reference": encode_reference,
         "preprocess": preprocess, "clipseg": clipseg,
         "preprocess_clipseg": preprocess_clipseg, "text_view": text_view,
         "no_distill_view": no_distill_view, "no_distill_train": no_distill_train,
         "serve_bf16": serve_bf16, "attn_bf16_kernel_rows": attn_bf16_rows,
         "encode_bf16": encode_bf16, "train_bf16": train_bf16,
         "eval": evaluation, "amg": amg, "cull": cull, "viewer": viewer,
         "viewer_train": viewer_train, "dino": dino, "data": data, "zoo": zoo,
         "zoo_reference": zoo_reference, "quality": quality, "export": export,
         "pose": pose, "dist": dist,
         "tools": tools, "kernels": kernels}, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
