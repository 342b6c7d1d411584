"""Data parallelism and the sharded frame across cards.

Run under ``torchrun``, one process per card (one card too: the script
starts a group of one), from the repository root::

    torchrun --standalone --nproc-per-node 4 -m samnerf_tpu_torch.scripts.bench_dist \\
        [--steps 8] [--warmup 2] [--frames 3] [--size 512]

Every rank trains full-width ``samnerf_distill`` (seeded weights, 16384
rays a step: the global batch, each rank its share) on its own copy of
the synthetic 512x512 scene: ms per step (host clock, synchronised), the
gradient all-reduce's ms, F32-ENC and F32-ENC-BWD launches per step, and
a digest of every parameter after the steps, which must be equal on all
ranks.  Then a full-width baked int8 fused frame through
``build_sharded_frame_fn`` with a click: ms per frame, FUSED-QMLP
launches per rank per frame, and on rank 0 the overlay against
``serve_frame_fn``'s (the largest difference of the uint8 frames, which
must stay within ``chip_smoke.TOL_FRAME``).  Rank 0 prints the card's name
and power limit and one JSON line, and writes ``chiprun_out/bench_dist.json``.
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


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def train_steps(dev, root: Path, steps: int, warmup: int) -> dict:
    """The data-parallel trainer's timed steps on this rank."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.parallel import mesh
    from samnerf_tpu_torch.scripts.profile_train import build_trainer
    from samnerf_tpu_torch.utils.synthetic import write_scene

    scene = write_scene(root / "scene", num_train=24, num_test=2, h=512, w=512,
                        with_features=True, feature_long_side=64)
    trainer = build_trainer(scene, root / "out", dev)
    if not trainer.distributed:
        raise RuntimeError("no process group: run under torchrun")
    for step in range(warmup):
        trainer.train_iteration(step)
    _sync(dev)
    launches = (hg.parity_hash_encode.launches, hg.parity_hash_encode_bwd.launches)
    times = []
    for step in range(warmup, warmup + steps):
        t0 = time.perf_counter()
        metrics = trainer.train_iteration(step)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = (hg.parity_hash_encode.launches - launches[0],
                hg.parity_hash_encode_bwd.launches - launches[1])
    all_reduce, ar_ms = mesh.all_reduce_grads, []

    def timed(params):
        _sync(dev)
        t0 = time.perf_counter()
        all_reduce(params)
        _sync(dev)
        ar_ms.append((time.perf_counter() - t0) * 1e3)

    mesh.all_reduce_grads = timed
    try:
        for step in range(warmup + steps, warmup + steps + 3):
            trainer.train_iteration(step)
    finally:
        mesh.all_reduce_grads = all_reduce
    digest = torch.stack([p.detach().double().sum() for p in trainer.model.parameters()])
    digests = mesh.all_gather_rows(digest[None])
    grad_bytes = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    return dict(step_ms=statistics.median(times), step_ms_all=times,
                all_reduce_ms=statistics.median(ar_ms), all_reduce_ms_all=ar_ms,
                grad_bytes=grad_bytes,
                launches_per_step={"F32-ENC": launches[0] / steps,
                                   "F32-ENC-BWD": launches[1] / steps},
                ranks_equal=bool((digests == digests[0]).all()),
                last_losses={k: float(v) for k, v in metrics.items()})


def sharded_frame(dev, size: int, frames: int, cfg=None) -> dict:
    """``build_sharded_frame_fn`` over the group with baked int8 fused
    tables and a click; rank 0 compares it with ``serve_frame_fn``."""
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.eval_render import build_sharded_frame_fn
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params
    from samnerf_tpu_torch.ops import hash_grid as hg
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
    frame(cams, 0, coords, labels)                      # warm-up
    _sync(dev)
    before = hg.parity_hash_encode_qmlp.launches
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = frame(cams, 0, coords, labels)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    result = dict(frame_ms=statistics.median(times), frame_ms_all=times,
                  fused_qmlp_per_frame=(hg.parity_hash_encode_qmlp.launches - before) / frames)
    if mesh.is_main_process():
        mine = (torch.clamp(out["masked_rgb"], 0.0, 1.0) * 255.0).to(torch.uint8)
        ref = snr.serve_frame_fn(sam, size, size)(cams, 0, click)
        result["overlay_max_diff"] = int((mine.int() - ref.int()).abs().max())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
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
        with tempfile.TemporaryDirectory() as tmp:
            train = train_steps(dev, Path(tmp), args.steps, args.warmup)
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
    result = {"card": smi, "world_size": len(per_rank), "ranks": per_rank}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "bench_dist.json").write_text(json.dumps(result, indent=1))
    print(smi[0])
    print(json.dumps({"world_size": len(per_rank),
                      "step_ms": [r["train"]["step_ms"] for r in per_rank],
                      "all_reduce_ms": [r["train"]["all_reduce_ms"] for r in per_rank],
                      "ranks_equal": per_rank[0]["train"]["ranks_equal"],
                      "frame_ms": [r["frame"]["frame_ms"] for r in per_rank],
                      "fused_qmlp_per_frame": [r["frame"]["fused_qmlp_per_frame"]
                                               for r in per_rank],
                      "overlay_max_diff": per_rank[0]["frame"]["overlay_max_diff"]}))
    bad = (not per_rank[0]["train"]["ranks_equal"]
           or per_rank[0]["frame"]["overlay_max_diff"] > 255 * TOL_FRAME)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
