"""Where the time of a served frame goes on the card.

Serves full-width ``samnerf_distill`` 512x512 frames (random weights from
a seed, static preset, f32 tables, baked int8 tables, and baked int8
tables through FUSED-QMLP with ``serve_fuse_mlp``) under
``torch.profiler`` and prints, per table kind, the frame's wall time, the
device busy time (the sum of its kernels: one stream, so they do not
overlap), the idle share, and device time per kernel name, largest first.
Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_serve [--frames 3]

Writes ``chiprun_out/profile_serve.json``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
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
        model = SAMModel(dataclasses.replace(cfg, hash_q8_serve=q8, serve_fuse_mlp=fuse),
                         device=dev)
        model.load_state_dict(params)
        snr = SamNerfRenderer(model, serve_preset="static")
        if q8:
            snr.bake_serve_tables()
        serve = snr.serve_frame_fn(sam, 512, 512)
        serve(_camera(dev, 0), 0, (256.0, 256.0))                 # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, args.frames + 1):
                serve(_camera(dev, i), 0, (100.0 + 50 * i, 300.0))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
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
        report[tag] = dict(wall_ms_per_frame=wall_ms, busy_ms_per_frame=busy,
                           idle_share=1.0 - busy / wall_ms, kernels=rows)
        print(f"\n{tag}: wall {wall_ms:.2f} ms/frame (profiled), device busy "
              f"{busy:.2f} ms/frame, idle share {1.0 - busy / wall_ms:.3f}")
        for r in rows[:15]:
            print(f"  {r['ms_per_frame']:8.3f} ms {100 * r['share']:5.1f}% "
                  f"x{r['launches_per_frame']:6.1f}  {r['kernel']}")
        del model, snr, serve, prof
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_serve.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
