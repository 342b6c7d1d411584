"""Where the time of one SAM ViT-H image encode goes on the card.

Builds ViT-H at full width (random weights from a seed, through
``build_sam`` with a reference-layout checkpoint), sets 512x512 frames
of a synthetic scene through ``SamPredictor.set_image`` (each resized to
1024x1024) and, after a warm-up, times images unprofiled (host clock,
synchronised), then profiles as many under ``torch.profiler`` and prints
the device busy time per image (the sum of its kernels: one stream, so
they do not overlap), the idle share (1 - busy / unprofiled image time)
and device time per kernel name with launches per image, largest first,
FLASH-RELPOS's time in use and launches per image, and the peak memory
of the unprofiled images.  Run from the repository root on a machine with
an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_encode [--images 3] [--tag NAME] \\
        [--dtype bfloat16]

``--dtype`` is the encoder's ``compute_dtype`` (``build_sam(...,
compute_dtype=)``; default float32), so the f32 and the bf16 image can be
profiled in turns on one card.  Writes
``chiprun_out/profile_encode[_NAME].json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from samnerf_tpu_torch.ops import cuda_build
from samnerf_tpu_torch.perception.sam.build_sam import build_sam
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.scripts.profile_serve import _kernel_name, port_kernel_totals
from samnerf_tpu_torch.utils.init import init_state
from samnerf_tpu_torch.utils.synthetic import write_scene


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=3)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    cuda_build.build_all()
    n = args.images
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "sam_vit_h_seeded.pth"
        torch.save(init_state(build_sam("vit_h", device="meta"),
                              torch.Generator(device=dev).manual_seed(3), device="cpu"),
                   ckpt)
        scene = write_scene(Path(tmp) / "scene", num_train=2 * n + 1, num_test=0,
                            h=512, w=512)
        images = [np.asarray(Image.open(p).convert("RGB"))
                  for p in sorted((scene / "images").glob("*.png"))]
        predictor = SamPredictor(build_sam("vit_h", checkpoint=str(ckpt), device=dev,
                                           compute_dtype=args.dtype))
    predictor.set_image(images[0])                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for img in images[1:n + 1]:
        predictor.set_image(img)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in images[n + 1:]:
            predictor.set_image(img)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = _kernel_name(e.name)
            per_kernel[name] += e.time_range.elapsed_us() / 1e3 / n
            launches[name] += 1
    busy = sum(per_kernel.values())
    rows = [dict(kernel=k, ms_per_image=v, launches_per_image=launches[k] / n,
                 share=v / busy) for k, v in per_kernel.most_common()]
    in_use = port_kernel_totals(rows, "image")
    report = dict(card=smi, dtype=args.dtype, wall_ms_per_image=wall_ms,
                  profiled_ms_per_image=profiled_ms,
                  busy_ms_per_image=busy, idle_share=1.0 - busy / wall_ms,
                  max_memory_allocated=peak, port_kernels=in_use,
                  launches_per_image=sum(launches.values()) / n, kernels=rows)
    print(f"vit_h {args.dtype} image: wall {wall_ms:.2f} ms (unprofiled), {profiled_ms:.2f} ms "
          f"(profiled); device busy {busy:.2f} ms/image, idle share "
          f"{report['idle_share']:.3f}, {report['launches_per_image']:.0f} launches/image, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; in use: "
          + ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']:g}" for k, v in in_use.items()))
    for r in rows[:20]:
        print(f"  {r['ms_per_image']:8.3f} ms {100 * r['share']:5.1f}% "
              f"x{r['launches_per_image']:6.1f}  {r['kernel']}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    name = f"profile_encode_{args.tag}.json" if args.tag else "profile_encode.json"
    (out / name).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
