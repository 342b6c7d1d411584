"""Where the time of a training step goes on the card.

Trains full-width ``samnerf_distill`` (random initial weights from a
seed, 16384 rays per step) on a synthetic 512x512 scene: 24 train images,
SAM maps 64x64x256, ClipSeg maps 32x32x192.  After warm-up it times steps
unprofiled (host clock, synchronised), then profiles as many under
``torch.profiler`` and prints the device busy time per step (the sum of
its kernels: one stream, so they do not overlap), the idle share
(1 - busy / unprofiled step time) and device time per kernel name with
launches per step, largest first.  Run from the repository root on a
machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_train [--steps 5]

Writes ``chiprun_out/profile_train.json``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.data.datamanager import DataManager
from samnerf_tpu_torch.engine.trainer import Trainer
from samnerf_tpu_torch.ops import cuda_build
from samnerf_tpu_torch.scripts.profile_serve import _kernel_name
from samnerf_tpu_torch.utils.synthetic import write_scene


def build_trainer(scene: Path, output_dir: Path, device, seed: int = 0) -> Trainer:
    """The ``samnerf_distill`` trainer at full width on ``scene``."""
    method = method_configs()["samnerf_distill"]
    method.datamanager.dataparser.data = scene
    dm = DataManager(method.datamanager)
    tcfg = dataclasses.replace(method.trainer, seed=seed, output_dir=output_dir,
                               save_final=False)
    return Trainer(method.model, tcfg, method.optimizers, dm, device=device)


def build_synthetic_trainer(root: Path, device, seed: int = 0) -> Trainer:
    """The ``samnerf_distill`` trainer at full width on a synthetic
    512x512 scene written under ``root``."""
    scene = write_scene(root / "scene", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    return build_trainer(scene, root / "out", device, seed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    cuda_build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_synthetic_trainer(Path(tmp), dev)
        step = 0
        for _ in range(args.warmup):
            trainer.train_iteration(step)
            step += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_iteration(step)
            step += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                trainer.train_iteration(step)
                step += 1
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    per_kernel = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        # device-side ranges of user annotations (Optimizer.step#Adam.step)
        # span kernels that are counted on their own
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = _kernel_name(e.name)
            per_kernel[name] += e.time_range.elapsed_us() / 1e3 / args.steps
            launches[name] += 1
    busy = sum(per_kernel.values())
    rows = [dict(kernel=k, ms_per_step=v, launches_per_step=launches[k] / args.steps,
                 share=v / busy) for k, v in per_kernel.most_common()]
    report = dict(card=smi, wall_ms_per_step=wall_ms, profiled_ms_per_step=profiled_ms,
                  busy_ms_per_step=busy, idle_share=1.0 - busy / wall_ms,
                  launches_per_step=sum(launches.values()) / args.steps, kernels=rows)
    print(f"train step: wall {wall_ms:.2f} ms (unprofiled), {profiled_ms:.2f} ms "
          f"(profiled); device busy {busy:.2f} ms/step, idle share "
          f"{report['idle_share']:.3f}, {report['launches_per_step']:.0f} launches/step")
    for r in rows[:20]:
        print(f"  {r['ms_per_step']:8.3f} ms {100 * r['share']:5.1f}% "
              f"x{r['launches_per_step']:6.1f}  {r['kernel']}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_train.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
