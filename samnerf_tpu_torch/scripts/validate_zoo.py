"""Zoo validation: train each zoo method end to end on the textured
synthetic scene and hold its eval PSNR against the best constant colour.

Each method runs in a process of its own through the train entry,
``python -m samnerf_tpu_torch.train <method> --data <scene>
--max-num-iterations N --rays-per-batch R --output-dir D``, which ends by
printing ``eval view 0 PSNR: <x>``.  The trivial baseline is the PSNR of
the best constant image (the per-channel mean) on that view: a method that
reconstructs the scene clears it by several dB.

Counterpart of ``scripts/validate_zoo.py``::

    python -m samnerf_tpu_torch.scripts.validate_zoo [--steps 2000]
        [--rays 4096] [--res 128] [--views 24] [--seed 42]
        [--methods name[:steps],...] [--out docs/ZOO_torch.md]

``--methods`` defaults to the whole zoo; ``name:steps`` gives a method its
own budget, which the train entry rounds up to a multiple of the method's
``dispatch_chunk`` (the table lists the steps run).  The table is rewritten after each method, so an interrupted
sweep keeps its rows, and names the card and its power limit.  Scene,
runs and per-method logs go under the system's temporary directory.  Runs
on the card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from samnerf_tpu_torch.scripts.quality_capacity import device_label

REPO_ROOT = Path(__file__).resolve().parents[2]
PSNR_LINE = re.compile(r"eval view 0 PSNR: ([0-9.]+)")
METHOD_TIMEOUT_S = 5400


def trivial_psnr(scene: Path) -> float:
    """PSNR of the best constant image (the per-channel mean) on the first
    eval view."""
    from PIL import Image

    meta = json.loads((Path(scene) / "transforms_test.json").read_text())
    img = np.asarray(Image.open(
        Path(scene) / meta["frames"][0]["file_path"])).astype(np.float32) / 255.0
    mse = float(((img - img.mean(axis=(0, 1))) ** 2).mean())
    return -10.0 * np.log10(max(mse, 1e-12))


def run_method(name: str, scene: Path, steps: int, rays: int, work: Path, seed: int = 42):
    """Train ``name`` through the train entry in a process of its own,
    its output in ``work/<name>.log``: (eval PSNR or None, seconds, the
    log's last lines)."""
    cmd = [sys.executable, "-m", "samnerf_tpu_torch.train", name, "--data", str(scene),
           "--max-num-iterations", str(steps), "--rays-per-batch", str(rays),
           "--output-dir", str(work / "runs"), "--seed", str(seed)]
    print(f"--- {name}: {' '.join(cmd[2:])}", flush=True)
    existing = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT) + (os.pathsep + existing
                                                        if existing else ""))
    log = work / f"{name}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with log.open("w") as f:
        r = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, text=True,
                           timeout=METHOD_TIMEOUT_S, cwd=str(REPO_ROOT), env=env)
    dt = time.time() - t0
    text = log.read_text()
    m = PSNR_LINE.search(text)
    tail = text.strip().splitlines()[-8:]
    if r.returncode != 0 or not m:
        return None, dt, tail
    return float(m.group(1)), dt, tail


def write_doc(out: Path, rows, args, base: float, card: str) -> None:
    lines = [
        "# Zoo-method validation (PyTorch port)",
        "",
        "Every zoo method trained end to end through the train entry",
        f"(`python -m samnerf_tpu_torch.train <method>`) x {args.rays} rays a step",
        f"on the textured synthetic scene ({args.views} train views, {args.res}x{args.res}, "
        f"detail x2), seed {args.seed},",
        f"on {card}.",
        f"Trivial baseline = best constant-colour image on the eval view: **{base:.2f} dB**.",
        "",
        "| method | steps | eval PSNR | vs trivial | train+eval wall |",
        "|---|---|---|---|---|",
    ]
    for name, n_steps, p, dt in rows:
        if p is None:
            lines.append(f"| {name} | {n_steps} | FAILED | — | {dt:.0f}s |")
        else:
            lines.append(f"| {name} | {n_steps} | {p:.2f} | {p - base:+.1f} dB | {dt:.0f}s |")
    lines += ["", "(generated by `python -m samnerf_tpu_torch.scripts.validate_zoo`)"]
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="samnerf_tpu_torch.scripts.validate_zoo")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--seed", type=int, default=42, help="the train entry's --seed")
    ap.add_argument("--methods", default="",
                    help="comma list (default: the whole zoo); a name:steps entry "
                         "overrides --steps for that method")
    ap.add_argument("--out", default="docs/ZOO_torch.md")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.validate_zoo: no CUDA device", file=sys.stderr)
        return 1
    from samnerf_tpu_torch.configs.zoo import zoo_methods
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene

    card = device_label("cuda")
    work = Path(tempfile.gettempdir()) / "zoo_runs"
    scene = write_textured_scene(Path(tempfile.gettempdir()) / "zoo_scene",
                                 num_train=args.views, num_test=2, h=args.res, w=args.res,
                                 detail=2.0)
    base = trivial_psnr(scene)
    print(f"trivial (best-constant) baseline PSNR: {base:.2f}", flush=True)
    steps_of, methods = {}, []
    for entry in [m for m in args.methods.split(",") if m]:
        name, _, s = entry.partition(":")
        methods.append(name)
        steps_of[name] = int(s) if s else args.steps
    zoo = zoo_methods()
    methods = methods or list(zoo)
    rows = []
    for name in methods:
        n_steps = steps_of.get(name, args.steps)
        p, dt, tail = run_method(name, scene, n_steps, args.rays, work, args.seed)
        chunk = zoo[name].dispatch_chunk
        n_steps = -(-n_steps // chunk) * chunk            # what the entry ran
        if p is None:
            print(f"  FAILED ({dt:.0f}s):\n   " + "\n   ".join(tail), flush=True)
        else:
            print(f"  PSNR {p:.2f} ({p - base:+.1f} dB over trivial, {dt:.0f}s)", flush=True)
        rows.append((name, n_steps, p, dt))
        write_doc(Path(args.out), rows, args, base, card)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
