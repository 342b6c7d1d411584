"""Train and evaluate one method over several scenes.

Counterpart of ``samnerf_tpu/scripts/benchmark.py``::

    python -m samnerf_tpu_torch.scripts.benchmark samnerf_distill \\
        --scenes dir1,dir2,... --output benchmark.json \\
        [--trainer.max-num-iterations N] [dotted overrides...]

Scenes train one after another on the card, each from a fresh preset with
the overrides applied, its run under ``<output_dir>/<scene>/<method>``,
``vis="json"`` unless ``--vis`` is given; each is scored by
``compute_eval_metrics`` (PSNR, SSIM over its eval images) and the summary
(per scene, with the training seconds, and the means) goes to
``--output``.  Exits 1 without a card, 2 on a bad command line.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from samnerf_tpu_torch.configs.cli import apply_overrides
    from samnerf_tpu_torch.configs.methods import method_configs

    registry = method_configs()
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(registry))
        return 0
    method = argv.pop(0)
    if method not in registry:
        print(f"unknown method {method!r}; methods: {', '.join(registry)}")
        return 2

    scenes, output, rest = [], Path("benchmark.json"), []
    it = iter(argv)
    for a in it:
        if a == "--scenes":
            scenes = [Path(s) for s in next(it).split(",") if s]
        elif a == "--output":
            output = Path(next(it))
        else:
            rest.append(a)
    if not scenes:
        print("--scenes dir1,dir2,... is required")
        return 2
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.benchmark: no CUDA device", file=sys.stderr)
        return 1

    from samnerf_tpu_torch import train as train_entry
    from samnerf_tpu_torch.utils import eval_utils

    rows = {}
    for scene in scenes:
        # a fresh preset per scene: apply_overrides changes the config in
        # place, so one object would compound output_dir over the scenes
        config = apply_overrides(method_configs()[method], rest)
        if not any(a == "--vis" or a.startswith("--vis=") for a in rest):
            config.vis = "json"
        config.datamanager.dataparser.data = scene
        config.trainer.output_dir = Path(config.trainer.output_dir) / scene.name / method
        train_entry.save_config(config)
        t0 = time.time()
        trainer = train_entry.train_loop(config, device=device)
        train_s = time.time() - t0
        metrics = eval_utils.compute_eval_metrics(trainer)
        metrics["train_s"] = round(train_s, 1)
        rows[scene.name] = metrics
        print(f"{scene.name}: {metrics}", flush=True)

    summary = {"method": method, "scenes": rows,
               "mean_psnr": sum(m["psnr"] for m in rows.values()) / len(rows),
               "mean_ssim": sum(m["ssim"] for m in rows.values()) / len(rows)}
    output.parent.mkdir(parents=True, exist_ok=True)
    output.write_text(json.dumps(summary, indent=2))
    print(f"wrote {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
