#!/usr/bin/env python3
"""Drive the PyTorch port (``samnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. build the CUDA kernels from ``samnerf_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the serve path's shapes (max abs error, time, bound);
4. serve: full-width ``samnerf_distill`` 512x512 frames through
   ``SamNerfRenderer.serve_frame_fn`` (static preset) with f32 tables and
   with baked int8 tables, launch counts per frame; then a 64x64 frame of
   a small model on the card against the same frame on the CPU, where
   every kernel runs its plain version;
5. train_kernels: the encode backward F32-ENC-BWD against its plain
   version, and F32-ENC's time, at the three encode shapes of a
   ``samnerf_distill`` training step (16384 rays);
6. train: full-width ``samnerf_distill`` training steps on a synthetic
   512x512 scene through the port's ``Trainer`` (ms per step, rays/s,
   peak memory, launches per step, losses); then one train step of a
   small model on the card against the same step on the CPU (losses and
   gradients);
7. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
   as the last line.

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
TOL_FRAME = 1e-3                # f32 card vs CPU, sums taken in other orders
# table gradients: f32 atomics vs a bf16-rounded sum (one bf16 step is 2^-8)
TOL_TABLE_GRAD = dict(rtol=1e-2, atol=1e-4)
TOL_DENSE_GRAD = dict(rtol=1e-3, atol=1e-5)   # f32 sums in other orders
TOL_LOSS = 1e-4
TOL_RELU_MARGIN = 1e-6          # conv pre-activations must keep this far from 0
TRAIN_WARMUP, TRAIN_STEPS = 3, 30


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


def kernel_phase(dev):
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    gen = torch.Generator(device=dev).manual_seed(0)
    # (name, levels, packs, log2 table size, points, min res, max res):
    # the point counts of one 32768-ray chunk of the static preset
    shapes = [("nerfacto", 16, 1, 19, 1 << 20, 16, 2048),
              ("proposal", 5, 1, 17, 1 << 21, 16, 128),
              ("sam_pyramid", 12, 4, 19, 1 << 18, 128, 512)]
    rows = []
    for name, L, P, log2, n, lo_res, hi_res in shapes:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo_res, hi_res).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        pos = torch.rand((n, 3), generator=gen, device=dev)
        variants = [("f32", 0, h) for h in ("morton", "reference")]
        if name != "proposal":
            variants += [("q8", 8, "morton"), ("q4", 4, "morton")]
        for kind, qbits, hash_fn in variants:
            if qbits:
                packed, scales = hg.quantize_parity_table(table, qbits=qbits)
                run = (lambda: hg.parity_hash_encode_q8(
                    packed, scales, pos, scalings, steps, hash_fn, qbits))
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
                       points=n, levels=L, packs=P, log2_table=log2,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       table_bytes_touched=tb)
            rows.append(row)
            print(f"kernel {kernel:7s} {name:11s} {kind:3s} {hash_fn:9s} "
                  f"N={n:8d} err={err:.3e} (tol {TOL_KERNEL:g}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}, {tb / 1e6:.1f} MB table)",
                  flush=True)
        del table, pos
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
    for q8 in (False, True):
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8), device=dev)
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
        hg.parity_hash_encode.launches = 0
        hg.parity_hash_encode_q8.launches = 0
        times = []
        for i, click in enumerate(clicks[1:], start=1):
            t0 = time.perf_counter()
            img = serve(_cameras(dev, i, H, W, 400.0), 0, click)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if img.dtype != torch.uint8 or tuple(img.shape) != (H, W, 3):
                raise AssertionError(f"frame {img.dtype} {tuple(img.shape)}")
        frames = len(times)
        launches = {"F32-ENC": hg.parity_hash_encode.launches,
                    "Q-ENC": hg.parity_hash_encode_q8.launches}
        tag = "int8" if q8 else "f32"
        results[tag] = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                            frames=frames, launches=launches,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"serve {tag:4s} 512x512 static: median frame {results[tag]['frame_ms']:.2f}"
              f" ms over {frames} frames ({', '.join(f'{t:.1f}' for t in times)}); "
              f"launches/frame F32-ENC={launches['F32-ENC'] / frames:g} "
              f"Q-ENC={launches['Q-ENC'] / frames:g}; max_memory_allocated="
              f"{results[tag]['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del model, snr, serve
    if results["f32"]["launches"]["F32-ENC"] == 0:
        raise AssertionError("F32-ENC never launched on the f32 serve path")
    if results["int8"]["launches"]["Q-ENC"] == 0:
        raise AssertionError("Q-ENC never launched on the int8 serve path")
    if results["int8"]["launches"]["F32-ENC"]:
        raise AssertionError("the int8 serve path ran an f32 encode")
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
    report = {}
    for q8 in (False, True):
        c = dataclasses.replace(cfg, hash_q8_serve=q8)
        outs = {}
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
        a, b = outs[str(dev)], outs["cpu"]
        errs = {k: (a[k] - b[k]).abs().max().item() for k in ("rgb", "sam", "clipseg")}
        agree = (a["mask"] == b["mask"]).float().mean().item()
        same = a["mask"] == b["mask"]
        img_err = (a["img"].int() - b["img"].int()).abs()[same].max().item()
        tag = "int8" if q8 else "f32"
        report[tag] = dict(grid_max_abs_err=errs, mask_agreement=agree,
                           frame_max_diff_outside_flips=img_err)
        print(f"reference {tag}: 64x64 card vs CPU grid max abs err {errs}, "
              f"mask agreement {agree:.5f}, frame max diff {img_err}", flush=True)
        if max(errs.values()) > TOL_FRAME or agree < 0.999 or img_err > 1:
            raise AssertionError(f"card and CPU frames disagree: {report[tag]}")
    return report


def _tol_ratio(out, ref, rtol, atol) -> float:
    """max |out - ref| / (atol + rtol |ref|): at most 1 inside the tolerance."""
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def train_kernel_phase(dev):
    """F32-ENC-BWD against its plain backward, and both encode kernels'
    times, at the encodes of one 16384-ray training step."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    gen = torch.Generator(device=dev).manual_seed(1)
    # (name, levels, packs, log2 table size, points, min res, max res)
    shapes = [("proposal", 5, 1, 17, 16384 * 64, 16, 128),
              ("nerfacto", 16, 1, 19, 16384 * 32, 16, 2048),
              ("sam_pyramid", 12, 4, 19, 16384 * 16, 128, 512)]
    rows = []
    for name, L, P, log2, n, lo_res, hi_res in shapes:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo_res, hi_res).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        pos = torch.rand((n, 3), generator=gen, device=dev)
        g = torch.randn((n, P * 2 * L), generator=gen, device=dev)
        live = torch.rand((n,), generator=gen, device=dev) >= 0.1
        g *= live[:, None]                       # rows of points outside the cube
        table_bytes = table.numel() * 4
        for hash_fn in ("morton", "reference"):
            run = lambda: hg.parity_hash_encode_bwd(g, pos, scalings, steps, hash_fn)
            plain = lambda: hg.parity_hash_encode_bwd_ref(g, pos, scalings, steps, hash_fn)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ratio = _tol_ratio(out, ref, **TOL_TABLE_GRAD)
            if not math.isfinite(ratio) or ratio > 1.0:
                raise AssertionError(f"F32-ENC-BWD {name} {hash_fn}: max abs err {err}, "
                                     f"{ratio:.3f} x the tolerance {TOL_TABLE_GRAD}")
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
            fwd_ms = _time_ms(fwd, reps=20)
            ftb = _touched_table_bytes(hg, pos, scalings, steps, hash_fn, P)
            fwd_bound_ms, fwd_bound_by = _bound(n, P * 2 * L, ftb, P * L)
            row = dict(kernel="F32-ENC-BWD", shape=name, hash_fn=hash_fn, points=n,
                       levels=L, packs=P, log2_table=log2, max_abs_err=err,
                       tol_ratio=ratio, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, table_bytes_touched=tb,
                       atomic_rmw_bytes=2 * tb,
                       atomic_rmw_ms=2 * tb / HBM_BYTES_PER_S * 1e3, fwd_ms=fwd_ms,
                       fwd_bound_ms=fwd_bound_ms, fwd_bound_by=fwd_bound_by)
            rows.append(row)
            print(f"train kernel {name:11s} {hash_fn:9s} N={n:8d} F32-ENC-BWD "
                  f"err={err:.3e} ({ratio:.3f} x tol) ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}); F32-ENC ms={fwd_ms:.4f} "
                  f"bound_ms={fwd_bound_ms:.4f}", flush=True)
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
                hg.parity_hash_encode.launches = 0
                hg.parity_hash_encode_bwd.launches = 0
                hg.parity_hash_encode_q8.launches = 0
            elif step > TRAIN_WARMUP:
                times.append((now - t_prev[0]) * 1e3)
            t_prev[0] = now

        trainer.cfg.max_num_iterations = TRAIN_WARMUP + TRAIN_STEPS
        trainer.train(step_callback=on_step)
        launches = {"F32-ENC": hg.parity_hash_encode.launches,
                    "F32-ENC-BWD": hg.parity_hash_encode_bwd.launches,
                    "Q-ENC": hg.parity_hash_encode_q8.launches}
        peak = torch.cuda.max_memory_allocated()
        rays = trainer.datamanager.config.train_num_rays_per_batch
        del trainer
    step_ms = statistics.median(times)
    rgb = [m["rgb_loss"] for m in losses]
    result = dict(step_ms=step_ms, step_ms_all=times, rays_per_s=rays / step_ms * 1e3,
                  steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, launches=launches,
                  launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
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
    if launches["F32-ENC"] == 0 or launches["F32-ENC-BWD"] == 0:
        raise AssertionError(f"an encode kernel never launched on the train path: {launches}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from samnerf_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)

    rows = kernel_phase(dev)
    train_rows = train_kernel_phase(dev)
    serve = serve_phase(dev)
    reference = reference_phase(dev)
    train = train_phase(dev)
    train_reference = train_reference_phase(dev)

    source = "samnerf_tpu_torch/csrc/hash_encode.cu"
    kernels = []
    # the nerfacto shape with the morton hash stands for each kernel: the
    # largest encode per launch of its main path; ``launches`` is the count
    # on that path (a serve run for the forward kernels, the timed train
    # steps for the backward), ``launches_by_path`` every path's count
    for name, replaces, run in (("F32-ENC", "samnerf_tpu/ops/hash_pallas.py:519", "f32"),
                                ("Q-ENC", "samnerf_tpu/ops/hash_pallas.py:1180", "int8")):
        mine = [r for r in rows if r["kernel"] == name]
        rep = next(r for r in mine if r["shape"] == "nerfacto"
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
                        "library_ms": None})
    rep = next(r for r in train_rows if r["shape"] == "nerfacto" and r["hash_fn"] == "morton")
    kernels.append({"name": "F32-ENC-BWD", "route": "cuda", "source": source,
                    "replaces": "samnerf_tpu/ops/hash_pallas.py:644",
                    "launches": train["launches"]["F32-ENC-BWD"],
                    "launches_by_path": {"train": train["launches"]["F32-ENC-BWD"]},
                    "max_abs_err": max(r["max_abs_err"] for r in train_rows),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None})
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "kernel_rows": rows, "train_kernel_rows": train_rows,
         "serve": serve, "reference": reference, "train": train,
         "train_reference": train_reference, "kernels": kernels}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
