"""Evaluate a run directory: render every eval image of its latest
checkpoint and write PSNR / SSIM as JSON.

Counterpart of ``samnerf_tpu/scripts/eval.py``, same JSON
(``experiment_name``, ``checkpoint_dir``, ``results``)::

    python -m samnerf_tpu_torch.scripts.eval RUN_DIR [--output F] [--max-images N]

RUN_DIR holds ``config.json`` and ``samnerf_tpu_torch_ckpts/step-*.pt``
(see :mod:`samnerf_tpu_torch.utils.eval_utils`).  Runs on the card; exits
1 when there is none.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser()
    p.add_argument("run_dir", type=str)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--max-images", type=int, default=None)
    a = p.parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.eval: no CUDA device", file=sys.stderr)
        return 1

    from samnerf_tpu_torch.engine.trainer import CKPT_DIR
    from samnerf_tpu_torch.utils.eval_utils import compute_eval_metrics, eval_setup

    trainer, config = eval_setup(Path(a.run_dir), device=device)
    metrics = compute_eval_metrics(trainer, max_images=a.max_images)
    out = {"experiment_name": config.method_name,
           "checkpoint_dir": str(Path(a.run_dir) / CKPT_DIR),
           "results": metrics}
    text = json.dumps(out, indent=2)
    print(text)
    if a.output:
        Path(a.output).write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
