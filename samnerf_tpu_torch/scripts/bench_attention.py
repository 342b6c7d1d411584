"""Time FLASH-RELPOS of a checkout of the port, so two checkouts can be
compared on one card: ``chip_smoke.attn_kernel_phase`` (SAM ViT-H's and
ViT-B's global layers, a small ragged one and ViT-H's peaky case; the
kernel beside its plain version and ``scaled_dot_product_attention``
with the materialised bias, each with its max abs error against the
plain version and the bounds of ``chip_smoke.attn_bound``) with more
repetitions, and each row's share of its bound.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 -m samnerf_tpu_torch.scripts.bench_attention [--root ROOT] [--tag NAME] \\
        [--dtype bfloat16]

``--dtype bfloat16`` times the bf16 kernel instead
(``chip_smoke.attn_bf16_kernel_phase``: ViT-H, ViT-B and the ragged shape
on bf16 operands, its bf16 bounds).

``ROOT`` is the checkout whose ``samnerf_tpu_torch`` is timed (default:
this one), for example a parent commit unpacked with ``git archive``
into an ignored directory such as ``_smoke_checkout/``.  Writes
``chiprun_out/bench_attention_<tag>.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke


def bench(dev, dtype="float32"):
    """The rows of ``chip_smoke.attn_kernel_phase`` (or, for bf16,
    ``attn_bf16_kernel_phase``) for this process's ``samnerf_tpu_torch``,
    with each row's share of its bound."""
    phase = (chip_smoke.attn_bf16_kernel_phase if dtype == "bfloat16"
             else chip_smoke.attn_kernel_phase)
    rows = phase(dev, reps=50, ref_reps=10)
    for row in rows:
        row["bound_share"] = row["bound_ms"] / row["ms"]
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None, help="the checkout whose kernel to time")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
        for mod in [m for m in sys.modules if m.startswith("samnerf_tpu_torch")]:
            del sys.modules[mod]
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    from samnerf_tpu_torch.ops import cuda_build
    print(f"kernel of {Path(cuda_build.__file__).resolve().parents[2]}", flush=True)
    cuda_build.load("attention_relpos")
    report = dict(card=smi, tag=args.tag, dtype=args.dtype, rows=bench(dev, args.dtype))
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"bench_attention_{args.tag}.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
