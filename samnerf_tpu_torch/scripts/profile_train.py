"""Where the time of a training step goes on the card.

Trains full-width ``samnerf_distill`` (random initial weights from a
seed, 16384 rays per step, the eager step: ``steps_per_dispatch`` 1;
``chip_smoke.py``'s dispatch_train phase times and profiles the preset's
graphed blocks beside it) on a synthetic 512x512 scene: 24 train images,
SAM maps 64x64x256, ClipSeg maps 32x32x192.  After warm-up it times steps
unprofiled (host clock, synchronised), then profiles as many under
``torch.profiler`` and prints the device busy time per step (the sum of
its kernels: one stream, so they do not overlap), the idle share
(1 - busy / unprofiled step time), the peak memory of the unprofiled
steps, the time in use of each of the port's kernels and layout passes
with its launches, and device time per kernel name with launches per
step, largest first.  Run from the repository root on a
machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.profile_train [--steps 5]

Writes ``chiprun_out/profile_train.json``.
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.data.datamanager import DataManager
from samnerf_tpu_torch.engine.trainer import Trainer
from samnerf_tpu_torch.ops import cuda_build
from samnerf_tpu_torch.scripts.profile_serve import _kernel_name, port_kernel_totals
from samnerf_tpu_torch.utils.synthetic import write_scene


def build_trainer(scene: Path, output_dir: Path, device, seed: int = 0,
                  method: str = "samnerf_distill",
                  steps_per_dispatch: Optional[int] = None) -> Trainer:
    """The trainer of ``method`` at full width on ``scene`` (the preset's
    ``steps_per_dispatch`` unless given)."""
    method = method_configs()[method]
    method.datamanager.dataparser.data = scene
    dm = DataManager(method.datamanager)
    tcfg = dataclasses.replace(method.trainer, seed=seed, output_dir=output_dir,
                               save_final=False)
    if steps_per_dispatch is not None:
        tcfg.steps_per_dispatch = steps_per_dispatch
    return Trainer(method.model, tcfg, method.optimizers, dm, device=device)


def build_synthetic_trainer(root: Path, device, seed: int = 0,
                            steps_per_dispatch: Optional[int] = None) -> Trainer:
    """The ``samnerf_distill`` trainer at full width on a synthetic
    512x512 scene written under ``root``."""
    scene = write_scene(root / "scene", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    return build_trainer(scene, root / "out", device, seed,
                         steps_per_dispatch=steps_per_dispatch)


def train_snapshot(trainer: Trainer):
    """A copy of the trainer's parameters, optimizer state, step state and
    batch generator."""
    return (copy.deepcopy(trainer.model.state_dict()),
            copy.deepcopy(trainer.optimizer.state_dict()),
            dataclasses.replace(trainer.state), trainer.generator.get_state())


def restore_in_place(trainer: Trainer, snap) -> None:
    """``snap`` back into the trainer's own tensors, so that the graph of
    its block, which holds their addresses, stays valid."""
    model, opt, state, gen = snap
    trainer.model.load_state_dict(model)
    live = trainer.optimizer.state_dict()["optimizer"]["state"]
    for name, s in opt["optimizer"]["state"].items():
        for k, v in s.items():
            live[name][k].copy_(v)
    trainer.optimizer.count = opt["count"]
    trainer.state = dataclasses.replace(state)
    trainer.generator.set_state(gen)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def snapshot_distance(a, b, names) -> dict:
    """The worst relative L2 distance of the parameters ``names`` and of the
    Adam moments of two :func:`train_snapshot`s; raises unless their step
    counts agree."""
    (ma, sa, ta, _), (mb, sb, tb, _) = a, b
    if sa["count"] != sb["count"] or ta != tb:
        raise AssertionError(f"step counts differ: {sa['count']} {ta} against "
                             f"{sb['count']} {tb}")
    moments = max(max(_rel_l2(s["exp_avg"], sb["optimizer"]["state"][k]["exp_avg"]),
                      _rel_l2(s["exp_avg_sq"], sb["optimizer"]["state"][k]["exp_avg_sq"]))
                  for k, s in sa["optimizer"]["state"].items())
    return dict(params=max(_rel_l2(ma[k], mb[k]) for k in names), moments=moments)


def block_against_eager(trainer: Trainer, n: int) -> dict:
    """The trainer's captured block of ``n`` steps (its first block already
    run eagerly and captured) against the same steps run eagerly: from the
    state the trainer is in, put back in place each time, two eager runs of
    the ``n`` steps (blocks of one step, a sync a step) and one replay.
    ``gap``: the replay's distance from the first eager run
    (:func:`snapshot_distance`); ``spread``: the two eager runs' (F32-ENC-BWD
    sums table gradients with f32 atomics in a run-to-run order, so they
    differ); the last step's losses and their relative error; ms per step
    of the eager steps and of the replay.  The trainer is left in the
    replay's state."""
    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    names = [k for k, _ in trainer.model.named_parameters()]
    start = train_snapshot(trainer)
    runs, eager_ms = [], []
    for _ in range(2):
        restore_in_place(trainer, start)
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            loss = float(trainer.run_block(1)["total_loss"])
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        runs.append((train_snapshot(trainer), loss))
    restore_in_place(trainer, start)
    sync()
    t0 = time.perf_counter()
    replay_loss = float(trainer.run_block(n)["total_loss"])
    replay_ms = (time.perf_counter() - t0) * 1e3 / n
    (e0, eager_loss), (e1, _) = runs
    return dict(gap=snapshot_distance(train_snapshot(trainer), e0, names),
                spread=snapshot_distance(e1, e0, names), replay_loss=replay_loss,
                eager_loss=eager_loss,
                loss_rel_err=abs(replay_loss - eager_loss) / abs(eager_loss),
                eager_step_ms_all=eager_ms, replay_step_ms=replay_ms)


def capture_step_encodes(device, warmup: int = 2):
    """The inputs of every F32-ENC call of one training step and the
    cotangent its F32-ENC-BWD call gets, in call order: dicts of
    ``positions``, ``cotangent``, ``scalings``, ``num_steps``, ``hash_fn``,
    ``levels`` and ``packs``.  The step is the one after ``warmup`` steps
    of the full-width synthetic trainer (seed 0)."""
    from samnerf_tpu_torch.fields import hash_encoding

    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_synthetic_trainer(Path(tmp), device, steps_per_dispatch=1)
        for step in range(warmup):
            trainer.train_iteration(step)
        calls = []
        encode = hash_encoding.hash_encode

        def record(table, positions, scalings, num_steps, hash_fn="reference"):
            out = encode(table, positions, scalings, num_steps, hash_fn)
            call = dict(positions=positions.detach().clone(), scalings=tuple(scalings),
                        num_steps=num_steps, hash_fn=hash_fn, levels=len(scalings),
                        packs=table.shape[0] // len(scalings))
            if out.requires_grad:
                out.register_hook(
                    lambda g: call.update(cotangent=g.detach().contiguous().clone()))
            calls.append(call)
            return out

        hash_encoding.hash_encode = record
        try:
            trainer.train_iteration(warmup)
        finally:
            hash_encoding.hash_encode = encode
        del trainer
    if not all("cotangent" in c for c in calls):
        raise RuntimeError("an encode of the step got no cotangent")
    print("step encodes: " + ", ".join(f"{c['levels']}x{c['packs']} N={c['positions'].shape[0]}"
                                       for c in calls), flush=True)
    return calls


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
        trainer = build_synthetic_trainer(Path(tmp), dev, steps_per_dispatch=1)
        step = 0
        for _ in range(args.warmup):
            trainer.train_iteration(step)
            step += 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_iteration(step)
            step += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        peak = torch.cuda.max_memory_allocated()
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
    port = port_kernel_totals(rows, "step")
    report = dict(card=smi, wall_ms_per_step=wall_ms, profiled_ms_per_step=profiled_ms,
                  busy_ms_per_step=busy, idle_share=1.0 - busy / wall_ms,
                  max_memory_allocated=peak,
                  launches_per_step=sum(launches.values()) / args.steps,
                  port_kernels=port, kernels=rows)
    print(f"train step: wall {wall_ms:.2f} ms (unprofiled), {profiled_ms:.2f} ms "
          f"(profiled); device busy {busy:.2f} ms/step, idle share "
          f"{report['idle_share']:.3f}, {report['launches_per_step']:.0f} launches/step, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; in use "
          + ", ".join(f"{k} {v['ms']:.3f} ms x{v['launches']:g}" for k, v in port.items()))
    for r in rows[:20]:
        print(f"  {r['ms_per_step']:8.3f} ms {100 * r['share']:5.1f}% "
              f"x{r['launches_per_step']:6.1f}  {r['kernel']}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "profile_train.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
