"""Quality against hash-table capacity: train ``samnerf_distill`` on the
textured synthetic scene at several table sizes and record the test
split's PSNR and SSIM, the train split's PSNR, and the rendered SAM grid's
error against its distillation targets.

Counterpart of ``scripts/quality_capacity.py``::

    python -m samnerf_tpu_torch.scripts.quality_capacity [--steps 2000]
        [--rays 16384] [--views 24] [--res 128] [--detail 1.0]
        [--hash-fn reference|morton] [--capacities 15:13,17:15,19:17]
        [--smooth-texture] [--out docs/QUALITY_torch.md]

The scene and the runs go under the system's temporary directory.  The
table names the card and its power limit (``nvidia-smi``).  Runs on the
card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, for a
    CUDA device; "CPU" for the CPU."""
    if torch.device(device).type != "cuda":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def runs_dir() -> Path:
    """Where the quality scripts put their scenes and runs."""
    return Path(tempfile.gettempdir()) / "qruns"


def train_and_eval(scene, log2_size, prop_log2, steps, rays_per_batch,
                   args_views=24, hash_fn="reference", return_trainer=False,
                   skip_metrics=False, persist_run=True, compute_dtype=None,
                   steps_per_save=10 ** 9, run_name=None, load_dir=None,
                   device="cuda", step_callback=None):
    """Train the ``samnerf_distill`` preset with ``2^log2_size`` field and
    ``2^prop_log2`` proposal tables on ``scene`` (its train / test json
    split, SAM and ClipSeg targets) for ``steps`` steps of
    ``rays_per_batch`` rays, then measure: the mean PSNR / SSIM of the
    first 4 test images, the train PSNR of 2 views, the rendered SAM grid
    of train view 0 (average-pooled to the targets' size) against its
    targets (MSE, cosine), the training seconds and rays/s, and the
    steady-state ms per step (after the first).  ``step_callback(step,
    metrics)`` runs after each step."""
    from samnerf_tpu_torch.configs.methods import method_configs
    from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from samnerf_tpu_torch.utils.eval_utils import compute_eval_metrics
    from samnerf_tpu_torch.utils.metrics import psnr

    device = torch.device(device)
    preset = method_configs()["samnerf_distill"]
    model_cfg = dataclasses.replace(
        preset.model, log2_hashmap_size=log2_size, hashgrid_sizes=(log2_size, log2_size),
        proposal_net_args=tuple({**a, "log2_hashmap_size": prop_log2}
                                for a in preset.model.proposal_net_args),
        num_images=args_views, hash_fn=hash_fn,
        **({"compute_dtype": compute_dtype} if compute_dtype else {}))
    dm_cfg = DataManagerConfig(
        dataparser=DataparserConfig(data=Path(scene), train_val_json_split=True),
        train_num_rays_per_batch=rays_per_batch, patch_size=preset.model.patch_size,
        distill_sam=True, use_clipseg_feature=True)
    dm = DataManager(dm_cfg)
    t0 = time.time()
    trainer_cfg = TrainerConfig(
        max_num_iterations=steps, steps_per_save=steps_per_save,
        steps_per_eval_batch=10 ** 9,
        output_dir=runs_dir() / (run_name or f"{log2_size}-{hash_fn}-{steps}"),
        log_every=max(steps // 4, 1), save_final=persist_run,
        load_dir=Path(load_dir) if load_dir else None)
    trainer = Trainer(model_cfg, trainer_cfg, preset.optimizers, dm, device=device)
    start_step = int(trainer.state.step)          # nonzero when resuming
    if persist_run:
        # a servable run directory: config.json beside the checkpoints
        from samnerf_tpu_torch.train import save_config
        save_config(dataclasses.replace(preset, model=model_cfg, trainer=trainer_cfg,
                                        datamanager=dm_cfg))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = {}

    def after_step(step, metrics):
        if step == start_step + 1:                # the trainer synchronised after it
            first["t"] = time.perf_counter()
        if step_callback is not None:
            step_callback(step, metrics)

    trainer.train(step_callback=after_step)
    sync()
    t_end = time.perf_counter()
    train_s = time.time() - t0
    if skip_metrics:
        return None, trainer
    m = compute_eval_metrics(trainer, max_images=4)
    m["train_s"] = round(train_s, 1)
    m["rays_per_s"] = round((steps - start_step) * rays_per_batch / train_s)
    m["resumed_from"] = start_step
    timed = steps - start_step - 1
    m["step_ms"] = (t_end - first["t"]) * 1e3 / timed if timed > 0 else float("nan")

    # the train split's PSNR on 2 views: overfitting (train high, test
    # low) apart from a model that never learned (both low)
    renderer = ImageRenderer(trainer.model)
    cams = dm.cameras.to(device)
    tp = []
    for i in range(min(2, dm.cameras.num_cameras)):
        rgb = renderer.render_image_device(cams, i, cams.width, cams.height,
                                           minimal=True)["rgb"]
        if not bool(torch.isfinite(rgb).all()):
            print(f"  train view {i}: {int((~torch.isfinite(rgb)).sum())} non-finite values",
                  flush=True)
        gt = torch.as_tensor(dm.images[i], device=device).float() / 255.0
        tp.append(float(psnr(rgb, gt)))
    m["train_psnr"] = float(np.mean(tp))

    # distillation: the rendered SAM grid of train view 0 (what serving
    # decodes masks from in place of the ViT) against its targets
    rend = renderer.render_image(cams, 0, features=("sam",))["sam"]    # [fh, fw, 256]
    m.update(feature_error(rend, dm.sam_features[0]))
    if return_trainer:
        return m, trainer
    return m


def feature_error(rendered: np.ndarray, target: np.ndarray) -> dict:
    """``rendered`` [fh, fw, C] average-pooled to ``target``'s [gh, gw, C]
    grid: the mean squared error and the mean per-cell cosine (empty when
    the rendered grid is the smaller)."""
    kh = rendered.shape[0] // target.shape[0]
    kw = rendered.shape[1] // target.shape[1]
    if kh < 1 or kw < 1:
        return {}
    gh, gw = target.shape[:2]
    pooled = rendered[:gh * kh, :gw * kw].reshape(gh, kh, gw, kw, -1).mean((1, 3))
    return {"sam_feature_mse": float(np.mean((pooled - target) ** 2)),
            "sam_feature_cos": float(np.mean(
                np.sum(pooled * target, -1)
                / np.maximum(np.linalg.norm(pooled, axis=-1)
                             * np.linalg.norm(target, axis=-1), 1e-9)))}


def write_doc(out: Path, rows, args, card: str) -> None:
    """The capacity table into ``out``; sections (``## ...``) that the
    file already holds after its table, such as the mIoU study's, stay."""
    lines = [
        "# Quality vs hash-table capacity (PyTorch port)",
        "",
        "Textured synthetic scene (3 procedurally textured spheres and a",
        "textured ground, `samnerf_tpu_torch.utils.synthetic.write_textured_scene`,",
        f"texture detail x{args.detail:g}"
        + (", smooth multi-octave texture, 2x-supersampled ground truth),"
           if args.smooth_texture else ", binary checker / stripe texture),"),
        f"{args.views} train / 4 test views at {args.res}x{args.res}, {args.steps} steps of",
        f"`samnerf_distill` ({args.rays} rays a step), hash_fn={args.hash_fn},",
        f"on {card}.",
        "Reference capacity is 2^19 fields / 2^17 proposals.",
        "",
        "| field tables | proposal tables | test PSNR | train PSNR | SSIM "
        "| SAM-feat MSE | SAM-feat cos | train s | rays/s | ms/step |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for log2, plog2, m in rows:
        lines.append(f"| 2^{log2} | 2^{plog2} | {m['psnr']:.2f} | {m['train_psnr']:.2f} | "
                     f"{m['ssim']:.4f} | {m.get('sam_feature_mse', math.nan):.4f} | "
                     f"{m.get('sam_feature_cos', math.nan):.4f} | {m['train_s']} | "
                     f"{m['rays_per_s']} | {m['step_ms']:.2f} |")
    lines += ["", "(generated by `python -m samnerf_tpu_torch.scripts.quality_capacity`, "
              f"steps={args.steps})"]
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tail = ""
    if out.exists():
        old = out.read_text()
        idx = old.find("\n## ")
        if idx >= 0:
            tail = "\n" + old[idx + 1:]
    out.write_text("\n".join(lines) + "\n" + tail)


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="samnerf_tpu_torch.scripts.quality_capacity")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--detail", type=float, default=1.0)
    ap.add_argument("--hash-fn", default="reference", choices=("reference", "morton"))
    ap.add_argument("--capacities", default="15:13,17:15,19:17",
                    help="comma list of fieldlog2:proplog2 rows")
    ap.add_argument("--out", default="docs/QUALITY_torch.md")
    ap.add_argument("--smooth-texture", action="store_true",
                    help="continuous multi-octave texture and 2x supersampled "
                         "(anti-aliased) ground truth")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    args = parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.quality_capacity: no CUDA device", file=sys.stderr)
        return 1
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    card = device_label(device)
    scene = write_textured_scene(runs_dir() / "qscene", num_train=args.views, num_test=4,
                                 h=args.res, w=args.res, with_features=True,
                                 detail=args.detail, smooth_texture=args.smooth_texture,
                                 supersample=2 if args.smooth_texture else 1)
    rows = []
    for c in args.capacities.split(","):
        log2, plog2 = (int(x) for x in c.split(":"))
        print(f"--- capacity 2^{log2} / proposals 2^{plog2} on {card}", flush=True)
        m = train_and_eval(scene, log2, plog2, args.steps, args.rays, args_views=args.views,
                           hash_fn=args.hash_fn, device=device)
        print(m, flush=True)
        rows.append((log2, plog2, m))
        write_doc(Path(args.out), rows, args, card)     # an interrupted sweep keeps its rows
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
