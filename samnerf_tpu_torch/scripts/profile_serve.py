"""Where the time of a served frame goes on the card.

Serves full-width ``samnerf_distill`` 512x512 frames (random weights from
a seed, static preset, f32 tables, baked int8 tables, and baked int8
tables through FUSED-QMLP with ``serve_fuse_mlp``), first unprofiled
(median wall of synchronised frames, peak memory), then as many under
``torch.profiler``, and prints, per table kind, the frame's walls, the
device busy time (the sum of its kernels: one stream, so they do not
overlap), the idle share (1 - busy / unprofiled wall), the time in use
of each of the port's kernels and layout passes with its launches, and
device time per kernel name, largest first.  Run from the repository
root on a machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_serve [--frames 3] [--tables f32 ...]

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--tables", nargs="+", default=["f32", "int8", "int8_fused"],
                    choices=["f32", "int8", "int8_fused"], help="the table kinds to serve")
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
        serve = snr.serve_frame_fn(sam, 512, 512)
        serve(_camera(dev, 0), 0, (256.0, 256.0))                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(1, args.frames + 1):
            t0 = time.perf_counter()
            serve(_camera(dev, i), 0, (100.0 + 50 * i, 300.0))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, args.frames + 1):
                serve(_camera(dev, i), 0, (100.0 + 50 * i, 300.0))
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3 / args.frames
        per_kernel = collections.Counter()
        launches = collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = _kernel_name(e.name)
                per_kernel[name] += e.time_range.elapsed_us() / 1e3 / args.frames
                launches[name] += 1
        busy = sum(per_kernel.values())
        rows = [dict(kernel=k, ms_per_frame=v, launches_per_frame=launches[k] / args.frames,
                     share=v / busy) for k, v in per_kernel.most_common()]
        port = port_kernel_totals(rows, "frame")
        report[tag] = dict(wall_ms_per_frame=wall_ms, wall_ms_all=times,
                           profiled_ms_per_frame=profiled_ms, busy_ms_per_frame=busy,
                           idle_share=1.0 - busy / wall_ms, max_memory_allocated=peak,
                           port_kernels=port, kernels=rows)
        print(f"\n{tag}: wall {wall_ms:.2f} ms/frame (unprofiled median), "
              f"{profiled_ms:.2f} (profiled), device busy {busy:.2f} ms/frame, idle share "
              f"{1.0 - busy / wall_ms:.3f}, max_memory_allocated {peak / 2**30:.2f} GiB; in use "
              + ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']:g}" for k, v in port.items()))
        for r in rows[:15]:
            print(f"  {r['ms_per_frame']:8.3f} ms {100 * r['share']:5.1f}% "
                  f"x{r['launches_per_frame']:6.1f}  {r['kernel']}")
        del model, snr, serve, prof
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_serve.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
