"""Data parallelism and the sharded frame across cards.

Run under ``torchrun``, one process per card (one card too: the script
starts a group of one), from the repository root::

    torchrun --standalone --nproc-per-node 4 -m samnerf_tpu_torch.scripts.bench_dist \\
        [--blocks 3] [--frames 3] [--size 512]

Every rank trains full-width ``samnerf_distill`` (seeded weights, 16384
rays a step: the global batch, each rank its share) on its own copy of
the synthetic 512x512 scene in the preset's blocks of 20 steps: the first
block runs eagerly and is captured, one CUDA graph replay a block on every
rank.  From that state (``profile_train.block_against_eager``) two eager
runs of the 20 data-parallel steps (a sync a step) and a replay: the
replay's parameters, Adam moments and last loss must lie within
``DISPATCH_SPREAD`` times the eager runs' spread (or ``DISPATCH_FLOOR``)
and ``TOL_LOSS`` on every rank.  Then ms per step of the eager steps and
of ``--blocks`` replays (a sync a block), the gradient all-reduce's ms
alone (``mesh.all_reduce_grads`` on 842 MiB, a sync around each), F32-ENC
and F32-ENC-BWD per replayed step by name in a profiler trace of one
replay, and a digest of every parameter, which must be equal on all
ranks.

Then a full-width baked int8 fused frame through ``build_sharded_frame_fn``
with a click: ms per replayed and per eager frame, FUSED-QMLP per replay on
the card by name, the replay against the eager frame (bit for bit), and on
rank 0 the overlay against ``serve_frame_fn``'s (the largest difference of
the uint8 frames, which must stay within ``TOL_FRAME``).  Rank 0 prints
the card's name and power limit and one JSON line, and writes
``chiprun_out/bench_dist_<world size>.json``; the exit code is 1 where a
check failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

TOL_FRAME = 1e-3
# a replayed block against the eager steps, as chip_smoke.py holds it
DISPATCH_SPREAD = 4.0
DISPATCH_FLOOR = 1e-6
TOL_LOSS = 1e-4
F32_PER_STEP = 6                # F32-ENC, and F32-ENC-BWD, a samnerf_distill step
ALL_REDUCE_REPS = 5             # timed all-reduces alone; the first allocates


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def train_blocks(dev, scene: Path, out: Path, blocks: int) -> dict:
    """The data-parallel trainer on this rank: its block against the eager
    steps, ms per step eager and replayed, the gradient all-reduce's ms
    alone, the kernels of a replay by name, the ranks' parameter
    digests."""
    from samnerf_tpu_torch.ops import kernel_launches
    from samnerf_tpu_torch.parallel import mesh
    from samnerf_tpu_torch.scripts.profile_train import block_against_eager, build_trainer

    trainer = build_trainer(scene, out, dev)
    if not trainer.distributed:
        raise RuntimeError("no process group: run under torchrun")
    n = trainer.block
    trainer.run_block(n)                                # eager, then captured
    check = block_against_eager(trainer, n)
    block_ms = [check["replay_step_ms"]]
    for _ in range(blocks - 1):
        t0 = time.perf_counter()
        trainer.run_block(n)
        _sync(dev)
        block_ms.append((time.perf_counter() - t0) * 1e3 / n)
    want = {"F32-ENC": F32_PER_STEP * n, "F32-ENC-BWD": F32_PER_STEP * n}
    metrics, trace = kernel_launches.traced(lambda: trainer.run_block(n), want,
                                            lambda _, counts: counts == want)
    digest = torch.stack([p.detach().double().sum() for p in trainer.model.parameters()])
    digests = mesh.all_gather_rows(digest[None])
    probe = [torch.nn.Parameter(torch.zeros_like(p)) for p in trainer.model.parameters()]
    for q in probe:
        q.grad = torch.ones_like(q)
    ar_ms = []
    for _ in range(ALL_REDUCE_REPS):
        _sync(dev)
        t0 = time.perf_counter()
        mesh.all_reduce_grads(probe)
        _sync(dev)
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    grad_bytes = sum(q.numel() * q.element_size() for q in probe)
    steps_by_dispatch = dict(trainer.steps_by_dispatch)
    del trainer, probe
    spread, gap = check["spread"], check["gap"]
    within = (max(gap.values()) <= max(DISPATCH_SPREAD * max(spread.values()), DISPATCH_FLOOR)
              and check["loss_rel_err"] <= TOL_LOSS)
    return dict(block=n, gap=gap, spread=spread, replay_loss=check["replay_loss"],
                eager_loss=check["eager_loss"], loss_rel_err=check["loss_rel_err"],
                replay_within_eager=within,
                eager_step_ms=statistics.median(check["eager_step_ms_all"]),
                eager_step_ms_all=check["eager_step_ms_all"],
                block_step_ms=statistics.median(block_ms), block_step_ms_all=block_ms,
                steps_by_dispatch=steps_by_dispatch,
                all_reduce_ms=statistics.median(ar_ms[1:]), all_reduce_ms_all=ar_ms,
                grad_bytes=grad_bytes,
                replay_on_card_per_step={k: v / n for k, v in trace.counts.items()},
                trace_tries=trace.tries,
                ranks_equal=bool((digests == digests[0]).all()),
                last_losses={k: float(v) for k, v in metrics.items()})


def sharded_frame(dev, size: int, frames: int, cfg=None) -> dict:
    """``build_sharded_frame_fn`` over the group with baked int8 fused
    tables and a click, replayed and eager; rank 0 compares it with
    ``serve_frame_fn``."""
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.eval_render import build_sharded_frame_fn
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import kernel_launches
    from samnerf_tpu_torch.parallel import mesh
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    cfg = dataclasses.replace(cfg or SAMModelConfig(hash_fn="morton"), hash_q8_serve=True,
                              serve_fuse_mlp=True)
    gen = torch.Generator().manual_seed(0)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_params(cfg, gen, device=dev))
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(gen, device=dev))
    snr = SamNerfRenderer(model, serve_preset="static")
    snr.bake_serve_tables()
    frame = build_sharded_frame_fn(snr.renderer, size, size, ("sam", "clipseg"), sam=sam)
    click = (0.2 * size, 0.6 * size)
    coords = torch.zeros((1, 4, 2), device=dev)
    coords[0, 0] = torch.tensor([c * 1024.0 / size for c in click])
    labels = torch.full((1, 4), -1, dtype=torch.int32, device=dev)
    labels[0, 0] = 1
    c2w = torch.eye(4, device=dev)[:3, :4].clone()
    c2w[:, 3] = torch.tensor([0.03, -0.02, 1.45])
    focal = torch.tensor([[0.78 * size]], device=dev)
    half = torch.tensor([[size / 2.0]], device=dev)
    cams = Cameras(camera_to_worlds=c2w[None], fx=focal, fy=focal, cx=half, cy=half,
                   width=size, height=size)
    frame(cams, 0, coords, labels)                      # eager, then captured
    _sync(dev)
    result = {}
    for name, fn in (("eager", frame.eager), ("replay", frame)):
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            out = fn(cams, 0, coords, labels)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        result[name] = out
        result[f"{name}_frame_ms"] = statistics.median(times)
        result[f"{name}_frame_ms_all"] = times
    eager, out = result.pop("eager"), result.pop("replay")
    result["replay_is_eager"] = all(torch.equal(out[k], eager[k]) for k in eager)
    _, trace = kernel_launches.traced(lambda: frame(cams, 0, coords, labels), ("FUSED-QMLP",))
    result["fused_qmlp_per_replay"] = trace.counts["FUSED-QMLP"]
    if mesh.is_main_process():
        mine = (torch.clamp(out["masked_rgb"], 0.0, 1.0) * 255.0).to(torch.uint8)
        ref = snr.serve_frame_fn(sam, size, size)(cams, 0, click)
        result["overlay_max_diff"] = int((mine.int() - ref.int()).abs().max())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dist: no CUDA device")
    from samnerf_tpu_torch.ops import cuda_build
    from samnerf_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a group even of one rank (torchrun's environment), so that one card
    # runs the same collectives as several
    torch.cuda.set_device(mesh.local_rank())
    torch.distributed.init_process_group("nccl")
    rank = mesh.rank()
    try:
        dev = torch.device("cuda", mesh.local_rank())
        if mesh.is_main_process():
            cuda_build.build_all()
        torch.distributed.barrier()
        from samnerf_tpu_torch.utils.synthetic import write_scene

        with tempfile.TemporaryDirectory() as tmp:
            scene = write_scene(Path(tmp) / "scene", num_train=24, num_test=2, h=512, w=512,
                                with_features=True, feature_long_side=64)
            train = train_blocks(dev, scene, Path(tmp) / "out", args.blocks)
        frame = sharded_frame(dev, args.size, args.frames)
        per_rank = [None] * mesh.world_size()
        torch.distributed.all_gather_object(per_rank, {"train": train, "frame": frame})
    finally:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()
    world = len(per_rank)
    result = {"card": smi, "world_size": world, "ranks": per_rank}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"bench_dist_{world}.json").write_text(json.dumps(result, indent=1))
    print(smi[0])
    train = [r["train"] for r in per_rank]
    frames = [r["frame"] for r in per_rank]
    print(json.dumps({"world_size": world,
                      "eager_step_ms": [t["eager_step_ms"] for t in train],
                      "block_step_ms": [t["block_step_ms"] for t in train],
                      "all_reduce_ms": [t["all_reduce_ms"] for t in train],
                      "gap": [t["gap"] for t in train], "spread": [t["spread"] for t in train],
                      "loss_rel_err": [t["loss_rel_err"] for t in train],
                      "replay_within_eager": [t["replay_within_eager"] for t in train],
                      "replay_on_card_per_step": [t["replay_on_card_per_step"] for t in train],
                      "ranks_equal": train[0]["ranks_equal"],
                      "frame_ms": [f["replay_frame_ms"] for f in frames],
                      "eager_frame_ms": [f["eager_frame_ms"] for f in frames],
                      "replay_is_eager": [f["replay_is_eager"] for f in frames],
                      "fused_qmlp_per_replay": [f["fused_qmlp_per_replay"] for f in frames],
                      "overlay_max_diff": frames[0]["overlay_max_diff"]}))
    bad = (not all(t["ranks_equal"] and t["replay_within_eager"]
                   and set(t["replay_on_card_per_step"].values()) == {F32_PER_STEP}
                   for t in train)
           or not all(f["replay_is_eager"] for f in frames)
           or frames[0]["overlay_max_diff"] > 255 * TOL_FRAME)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
