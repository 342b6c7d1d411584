"""Where the time of a served frame goes on the card.

Serves full-width ``samnerf_distill`` 512x512 frames through
``serve_frame_fn`` (one CUDA graph replay a frame; ``chip_smoke.py``'s
dispatch_serve phase profiles the eager frame beside it) (random weights
from a seed, static preset, f32 tables, baked int8 tables, and baked int8
tables through FUSED-QMLP with ``serve_fuse_mlp``), first unprofiled
(median wall of synchronised frames, peak memory), then as many under
``torch.profiler``, and prints, per table kind, the frame's walls, the
device busy time (the sum of its kernels: one stream, so they do not
overlap), the idle share (1 - busy / unprofiled wall), the kernel
launches per frame, the time in use
of each of the port's kernels and layout passes with its launches, and
device time per kernel name, largest first.  ``--cull`` also serves each
table kind culled: ``ball`` installs an occupancy grid of the cells in a
ball of radius 0.25 about the unit cube's centre, ``eps`` sets
``serve_transmittance_eps`` 1e-2, ``ball_eps`` both.  Run from the
repository root on a machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_serve [--frames 3] [--tables f32 ...] \
        [--cull none ball eps ball_eps]

Writes ``chiprun_out/profile_serve.json``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.engine.eval_render import occupancy_from_cells
from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
from samnerf_tpu_torch.ops import cuda_build
from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params


def _camera(dev, i: int) -> Cameras:
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:, 3] = [0.03 * i, -0.02 * i, 1.5 - 0.05 * i]
    f = torch.tensor([[400.0]], device=dev)
    c = torch.tensor([[256.0]], device=dev)
    return Cameras(camera_to_worlds=torch.as_tensor(c2w[None], device=dev),
                   fx=f, fy=f, cx=c, cy=c, width=512, height=512)


def _kernel_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[:90]


# the port's hand-written kernels and layout passes by their CUDA names
PORT_KERNELS = {"f32_encode_kernel": "F32-ENC", "pack_bf16_kernel": "BF16-PACK",
                "f32_encode_bwd_kernel": "F32-ENC-BWD",
                "deinterleave_grad_kernel": "GRAD-DEINTERLEAVE", "q_encode_kernel": "Q-ENC",
                "qmlp_kernel": "FUSED-QMLP", "flash_relpos_kernel": "FLASH-RELPOS",
                "flash_relpos_bf16_kernel": "FLASH-RELPOS-BF16",
                "flash_relpos_bf16_wgmma_kernel": "FLASH-RELPOS-BF16-WGMMA"}


def port_kernel_totals(rows, per: str) -> dict:
    """{port kernel: {ms, launches}} summed over the profile ``rows``
    (``ms_per_<per>``, ``launches_per_<per>``) whose kernel names carry
    it, template instances together."""
    totals = {}
    for r in rows:
        base = r["kernel"].split("<")[0].split()[-1]
        if base in PORT_KERNELS:
            t = totals.setdefault(PORT_KERNELS[base], dict(ms=0.0, launches=0.0))
            t["ms"] += r[f"ms_per_{per}"]
            t["launches"] += r[f"launches_per_{per}"]
    return totals


def profile_frames(serve, dev, frames: int, name: str) -> dict:
    """Walls of ``frames`` synchronised frames, then as many under the
    profiler: busy, idle share, peak memory, time by kernel; printed."""
    serve(_camera(dev, 0), 0, (256.0, 256.0))                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1, frames + 1):
        t0 = time.perf_counter()
        serve(_camera(dev, i), 0, (100.0 + 50 * i, 300.0))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, frames + 1):
            serve(_camera(dev, i), 0, (100.0 + 50 * i, 300.0))
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / frames
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel = _kernel_name(e.name)
            per_kernel[kernel] += e.time_range.elapsed_us() / 1e3 / frames
            launches[kernel] += 1
    busy = sum(per_kernel.values())
    rows = [dict(kernel=k, ms_per_frame=v, launches_per_frame=launches[k] / frames,
                 share=v / busy) for k, v in per_kernel.most_common()]
    port = port_kernel_totals(rows, "frame")
    total = sum(launches.values()) / frames
    print(f"\n{name}: wall {wall_ms:.2f} ms/frame (unprofiled median), "
          f"{profiled_ms:.2f} (profiled), device busy {busy:.2f} ms/frame, idle share "
          f"{1.0 - busy / wall_ms:.3f}, {total:g} kernel launches/frame, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; in use "
          + ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']:g}" for k, v in port.items()))
    for r in rows[:15]:
        print(f"  {r['ms_per_frame']:8.3f} ms {100 * r['share']:5.1f}% "
              f"x{r['launches_per_frame']:6.1f}  {r['kernel']}")
    return dict(wall_ms_per_frame=wall_ms, wall_ms_all=times, profiled_ms_per_frame=profiled_ms,
                busy_ms_per_frame=busy, idle_share=1.0 - busy / wall_ms,
                launches_per_frame=total, max_memory_allocated=peak, port_kernels=port,
                kernels=rows)


def ball_cells(res: int, radius: float = 0.25) -> np.ndarray:
    """[res]^3 0/1 cells inside a ball of ``radius`` about the unit cube's
    centre."""
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x * x + y * y + z * z <= radius * radius).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--tables", nargs="+", default=["f32", "int8", "int8_fused"],
                    choices=["f32", "int8", "int8_fused"], help="the table kinds to serve")
    ap.add_argument("--cull", nargs="+", default=["none"],
                    choices=["none", "ball", "eps", "ball_eps"],
                    help="the culling settings to serve each table kind with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    cuda_build.build_all()
    cfg = SAMModelConfig(hash_fn="morton")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    report = {"card": smi}
    for tag, q8, fuse in (("f32", False, False), ("int8", True, False),
                          ("int8_fused", True, True)):
        if tag not in args.tables:
            continue
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        for cull in args.cull:
            snr.occ = (occupancy_from_cells(ball_cells(cfg.occ_res), 0.5, device=dev)[0]
                       if "ball" in cull else None)
            snr.renderer.model.config = dataclasses.replace(
                snr.renderer.model.config, serve_transmittance_eps=1e-2 if "eps" in cull else 0.0)
            name = tag if cull == "none" else f"{tag}+{cull}"
            report[name] = profile_frames(snr.serve_frame_fn(sam, 512, 512), dev, args.frames,
                                          name)
        del model, snr
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_serve.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
