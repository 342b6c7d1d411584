"""The closed distillation loop: masks decoded from the rendered SAM grid
against masks from the ViT encoder.

A SAM feature grid rendered from the distilled field stands in for the
ViT image encoder in the mask decoder (``set_feature`` in place of
``set_image``).  This study closes that loop:

1. make per-view SAM targets with a ViT-B whose weights are drawn from a
   seeded ``torch.Generator`` (no released weights are used; random ViT
   features have fine spatial structure, unlike the procedural +-1 maps
   of ``utils/synthetic.py``);
2. train ``samnerf_distill`` at reference capacity on those targets;
3. for 2 train views and ``--test-views`` held-out views, decode masks at
   a grid x grid lattice of point prompts from ``set_feature(rendered
   grid)``, from ``set_image(rendered rgb)`` and from ``set_image(ground
   truth image)``, both through the encoder that made the targets, and
   report the mean IoU of the first against each of the others.

Counterpart of ``scripts/quality_distill_miou.py``::

    python -m samnerf_tpu_torch.scripts.quality_distill_miou [--steps 3000]
        [--rays 16384] [--views 24] [--res 256] [--detail 4.0] [--grid 64]
        [--log2 19] [--plog2 17] [--test-views 4] [--out docs/QUALITY_torch.md]
        [--persist] [--save-every 2500] [--run-name NAME] [--resume]

It writes its table as a section of ``--out`` (the capacity table above
it stays).  Scene and runs go under the system's temporary directory.
Runs on the card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from samnerf_tpu_torch.scripts.quality_capacity import device_label, runs_dir, train_and_eval

SECTION = "## Closed distillation loop"
DECODER_SEEDS = (1, 2, 3)
"""Seeds of the prompt encoders and mask decoders redrawn for the held-out
views after the main table: how far the mIoU moves with the random
decoder alone (the encoder, the targets and the field stay)."""


def build_target_sam(seed: int = 0, device="cuda"):
    """SAM ViT-B with ``init_state`` weights drawn from a generator on
    ``device`` seeded with ``seed``."""
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam_vit_b
    from samnerf_tpu_torch.utils.init import init_state

    sam = build_sam_vit_b(device="meta")
    sam.load_state_dict(init_state(sam, torch.Generator(device=device).manual_seed(seed),
                                   device), assign=True)
    return sam.eval()


def make_vit_features(scene: Path, sam=None, seed: int = 0, device="cuda"):
    """Replace the scene's ``sam_features/*.npy`` with ``sam``'s encoder
    output on each image (``build_target_sam(seed, device)`` when None):
    ``ResizeLongestSide``, ``Sam.preprocess``, the encoder; saved as
    [256, 64, 64] float32.  Returns (sam, ms per image)."""
    from PIL import Image

    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    sam = build_target_sam(seed, device) if sam is None else sam
    predictor = SamPredictor(sam)
    dev = predictor.device
    out_dir = Path(scene) / "sam_features"
    out_dir.mkdir(exist_ok=True)
    times = []
    for p in sorted((Path(scene) / "images").glob("*.png")):
        t0 = time.perf_counter()
        predictor.set_image(np.asarray(Image.open(p)))
        feat = predictor.get_image_embedding()[0].cpu().numpy()       # [64, 64, 256]
        times.append((time.perf_counter() - t0) * 1e3)
        np.save(out_dir / f"{p.stem}.npy", np.moveaxis(feat, -1, 0).astype(np.float32))
    print(f"  encoded {len(times)} views on {dev}: median "
          f"{np.median(times):.1f} ms per image", flush=True)
    return sam, times


def grid_mIoU(pred, grid: int, chunk: int = 256) -> np.ndarray:
    """Masks decoded at a grid x grid lattice of single point prompts over
    the predictor's current features: bool [grid * grid, H, W]."""
    h, w = pred.original_size
    ys = (np.arange(grid) + 0.5) / grid * h
    xs = (np.arange(grid) + 0.5) / grid * w
    pts = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 1, 2)
    pts_in = pred.transform.apply_coords(pts, pred.original_size)
    labels = np.ones((pts.shape[0], 1), np.int32)
    masks = []
    for i in range(0, pts.shape[0], chunk):
        m, _, _ = pred.predict_batched(pts_in[i:i + chunk].astype(np.float32),
                                       labels[i:i + chunk], multimask_output=False)
        masks.append(np.asarray(m[:, 0]))
    return np.concatenate(masks, axis=0)


def miou(a: np.ndarray, b: np.ndarray) -> float:
    """Mean IoU over the leading prompt axis; empty against empty counts 1."""
    inter = np.logical_and(a, b).sum((-2, -1)).astype(np.float64)
    union = np.logical_or(a, b).sum((-2, -1)).astype(np.float64)
    return float(np.where(union > 0, inter / np.maximum(union, 1), 1.0).mean())


def view_miou(renderer, cameras, i: int, sam, grid: int, gt_path=None,
              save_dir: Optional[Path] = None, tag: str = "test"):
    """(mIoU of the rendered grid's masks against ``set_image(rendered
    rgb)``'s, against ``set_image(ground truth)``'s, NaN without
    ``gt_path``) for camera ``i``.  The second is the serving claim:
    rendered features replace the encoder on the real view; the first
    keeps rgb reconstruction error out of it."""
    from PIL import Image

    from samnerf_tpu_torch.engine.eval_render import get_feature_size
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor

    out = renderer.render_image(cameras, i, features=("sam",))
    rgb = np.clip(out["rgb"], 0, 1)
    if save_dir is not None:
        Image.fromarray((rgb * 255).astype(np.uint8)).save(save_dir / f"{tag}_{i}_render.png")
    h, w = rgb.shape[:2]
    fh, fw = get_feature_size(h, w)
    pred = SamPredictor(sam)
    pred.set_feature(out["sam"][:fh, :fw], (h, w))
    masks_feat = grid_mIoU(pred, grid)
    pred.set_image((rgb * 255).astype(np.uint8))
    masks_img = grid_mIoU(pred, grid)
    v_gt = float("nan")
    if gt_path is not None:
        pred.set_image(np.asarray(Image.open(gt_path))[..., :3])
        v_gt = miou(masks_feat, grid_mIoU(pred, grid))
    return miou(masks_feat, masks_img), v_gt


def gt_paths(scene: Path, meta_name: str):
    meta = json.loads((scene / meta_name).read_text())
    return [scene / f["file_path"] for f in meta["frames"]]


def write_section(out: Path, args, m: dict, train_rows, rows, card: str,
                  target_ms: List[float], redrawn=()) -> None:
    """The mIoU table as the ``## Closed distillation loop`` section of
    ``out``, in place of an earlier one; ``redrawn``: (decoder seed,
    held-out rows) with the decoder redrawn."""
    mean = float(np.mean([r[0] for r in rows]))
    mean_gt = float(np.mean([r[1] for r in rows]))
    section = [
        "",
        f"{SECTION}: distilled-feature vs encoder masks (PyTorch port)",
        "",
        "Feature targets from the port's SAM ViT-B (weights from a seeded",
        "`torch.Generator`, `init_state`), trained at "
        f"2^{args.log2} / 2^{args.plog2} (morton hash)",
        f"for {args.steps} steps x {args.rays} rays on the textured scene "
        f"({args.views} views, {args.res}x{args.res}, detail x{args.detail:g}).",
        "Per view, masks decoded from `set_feature(rendered grid)` against",
        "`set_image(rendered rgb)` and `set_image(ground truth)` (the encoder",
        f"that made the targets) at a {args.grid}x{args.grid} point-prompt grid, "
        "single-mask decode.",
        "",
        "| view | mIoU vs set_image(rendered rgb) | mIoU vs set_image(GT image) | s |",
        "|---|---|---|---|",
    ]
    for i, (v, vg, dt) in enumerate(train_rows):
        section.append(f"| train {i} | {v:.4f} | {vg:.4f} | {dt:.1f} |")
    for i, (v, vg, dt) in enumerate(rows):
        section.append(f"| held-out {i} | {v:.4f} | {vg:.4f} | {dt:.1f} |")
    section.append(f"| **mean (held-out)** | **{mean:.4f}** | **{mean_gt:.4f}** | |")
    for seed, r in redrawn:
        section.append(f"| mean (held-out), decoder redrawn from seed {seed} | "
                       f"{np.mean([x[0] for x in r]):.4f} | {np.mean([x[1] for x in r]):.4f} | "
                       f"{sum(x[2] for x in r):.1f} |")
    section += [
        "",
        f"test PSNR {m['psnr']:.2f}, SSIM {m['ssim']:.4f}, train PSNR "
        f"{m['train_psnr']:.2f}, SAM-feat MSE {m.get('sam_feature_mse', float('nan')):.4f}, "
        f"cos {m.get('sam_feature_cos', float('nan')):.4f} (vs the ViT targets).",
        f"Training {m['train_s']:.1f} s ({m['rays_per_s']:,} rays/s, "
        f"{m['step_ms']:.2f} ms a step after the first) for {args.steps} x {args.rays} rays;",
        f"targets {np.median(target_ms):.1f} ms per image (median of {len(target_ms)}); "
        f"on {card}"
        + (f"; run persisted with checkpoints every {args.save_every} steps "
           f"and eval renders ({runs_dir() / args.run_name})." if args.persist and args.run_name
           else "."),
        "(generated by `python -m samnerf_tpu_torch.scripts.quality_distill_miou`)",
    ]
    out = Path(out)
    txt = out.read_text() if out.exists() else "# Quality (PyTorch port)\n"
    if SECTION in txt:
        txt = txt[:txt.index(SECTION)].rstrip() + "\n"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(txt + "\n".join(section) + "\n")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="samnerf_tpu_torch.scripts.quality_distill_miou")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--rays", type=int, default=16384)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--detail", type=float, default=4.0)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--log2", type=int, default=19)
    ap.add_argument("--plog2", type=int, default=17)
    ap.add_argument("--test-views", type=int, default=4)
    ap.add_argument("--out", default="docs/QUALITY_torch.md")
    ap.add_argument("--persist", action="store_true",
                    help="keep the run: config.json, checkpoints every --save-every "
                         "steps and at the end, and the views' renders")
    ap.add_argument("--save-every", type=int, default=2500)
    ap.add_argument("--run-name", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint of --run-name (the scene "
                         "and targets are made again, deterministically)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    args = parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.quality_distill_miou: no CUDA device",
              file=sys.stderr)
        return 1
    from samnerf_tpu_torch.engine.eval_render import ImageRenderer
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR
    from samnerf_tpu_torch.perception.sam.sam import init_decoder_params
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    card = device_label(device)
    scene = write_textured_scene(Path(tempfile.gettempdir()) / "miou_scene",
                                 num_train=args.views, num_test=4, h=args.res, w=args.res,
                                 with_features=True, detail=args.detail)
    print(f"--- ViT-B feature targets on {card}", flush=True)
    sam, target_ms = make_vit_features(scene, device=device)

    print(f"--- training samnerf_distill 2^{args.log2} ({args.steps} x {args.rays} rays)",
          flush=True)
    run_dir = runs_dir() / args.run_name if args.run_name else None
    m, trainer = train_and_eval(
        scene, args.log2, args.plog2, args.steps, args.rays, args_views=args.views,
        hash_fn="morton", return_trainer=True, persist_run=args.persist,
        steps_per_save=args.save_every if args.persist else 10 ** 9,
        run_name=args.run_name,
        load_dir=run_dir / CKPT_DIR if args.resume and run_dir else None, device=device)
    print(m, flush=True)

    renderer = ImageRenderer(trainer.model)
    dm = trainer.datamanager
    save_dir = None
    if args.persist and run_dir is not None:
        save_dir = run_dir / "eval_images"
        save_dir.mkdir(parents=True, exist_ok=True)
    train_paths = gt_paths(scene, "transforms_train.json")
    test_paths = gt_paths(scene, "transforms_test.json")

    def views(cameras, n, paths, tag):
        cams = cameras.to(trainer.device)
        rows = []
        for i in range(min(n, cameras.num_cameras)):
            t0 = time.perf_counter()
            v, v_gt = view_miou(renderer, cams, i, sam, args.grid, gt_path=paths[i],
                                save_dir=save_dir, tag=tag)
            rows.append((v, v_gt, time.perf_counter() - t0))
            print(f"  {tag} view {i}: mIoU vs set_image(render) = {v:.4f}, "
                  f"vs set_image(GT) = {v_gt:.4f} ({rows[-1][2]:.1f} s)", flush=True)
        return rows

    # train views first: the distilled features apart from novel-view error
    train_rows = views(dm.cameras, 2, train_paths, "train")
    rows = views(dm.eval_cameras, args.test_views, test_paths, "test")
    print(f"mean mIoU over {len(rows)} held-out views: "
          f"{np.mean([r[0] for r in rows]):.4f} (vs GT-image masks "
          f"{np.mean([r[1] for r in rows]):.4f}; train views "
          f"{np.mean([r[0] for r in train_rows]):.4f})", flush=True)
    redrawn = []
    for seed in DECODER_SEEDS:
        sam.load_state_dict(init_decoder_params(
            torch.Generator(device=device).manual_seed(seed), device), strict=False)
        redrawn.append((seed, views(dm.eval_cameras, args.test_views, test_paths,
                                    f"test_decoder{seed}")))
    write_section(Path(args.out), args, m, train_rows, rows, card, target_ms, redrawn)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
