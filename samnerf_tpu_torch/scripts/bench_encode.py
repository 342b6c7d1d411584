"""Time the hash kernels of a checkout of the port, so two checkouts can
be compared on one card: the quantized encodes (Q-ENC and FUSED-QMLP) at
uniform positions and at the positions a 512x512 static frame feeds each
serve head, and the f32 encode and its backward (F32-ENC, F32-ENC-BWD) at
the serve and training shapes, at uniform positions and at those of a
frame or of a training step (with the step's cotangents).

Run from the repository root on a machine with an NVIDIA GPU::

    # the positions of one full-width int8 fused frame (random weights,
    # seed 0) and the encodes of one full-width training step
    python3 -m samnerf_tpu_torch.scripts.bench_encode --capture POS.pt
    # the kernels of the checkout at ROOT (default: this one) on them
    python3 -m samnerf_tpu_torch.scripts.bench_encode --positions POS.pt \\
        [--root ROOT] [--tag NAME] [--only f32|quantized]

A checkout whose wrappers take the packed table layout (before
``interleave_packs``) is timed on that layout.  The f32 times include
the layout passes the wrappers launch.  Writes
``chiprun_out/bench_encode_<tag>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# the head of each fused call by its output width: proposal density,
# nerfacto density + geometry features, SAM, ClipSeg
HEAD_BY_OUT = {1: "proposal", 16: "nerfacto", 256: "sam", 192: "clipseg"}
# Q-ENC (name, levels, packs, log2 table size, uniform points, min res, max
# res, the head whose frame positions it takes, qbits): one 32768-ray
# chunk of the static preset
QENC_SHAPES = [("nerfacto", 16, 1, 19, 1 << 20, 16, 2048, "nerfacto", 8),
               ("nerfacto", 16, 1, 19, 1 << 20, 16, 2048, "nerfacto", 4),
               ("proposal", 5, 1, 17, 1 << 21, 16, 128, "proposal", 8),
               ("sam_pyramid", 12, 4, 19, 1 << 18, 128, 512, "sam", 8),
               ("sam_pyramid", 12, 4, 19, 1 << 18, 128, 512, "sam", 4)]
# F32-ENC (and F32-ENC-BWD where ``step``) (name, levels, packs, log2
# table size, uniform points, min res, max res, where): one 32768-ray
# chunk of the static preset (frame positions of the head of that name),
# and the encodes of one 16384-ray training step (step positions)
F32_SHAPES = [("nerfacto", 16, 1, 19, 1 << 20, 16, 2048, "frame"),
              ("proposal", 5, 1, 17, 1 << 21, 16, 128, "frame"),
              ("sam_pyramid", 12, 4, 19, 1 << 18, 128, 512, "frame"),
              ("proposal", 5, 1, 17, 16384 * 64, 16, 128, "step"),
              ("nerfacto", 16, 1, 19, 16384 * 32, 16, 2048, "step"),
              ("sam_pyramid", 12, 4, 19, 16384 * 16, 128, 512, "step")]
FRAME_HEAD = {"nerfacto": "nerfacto", "proposal": "proposal", "sam_pyramid": "sam"}
# FUSED-QMLP (head, uniform points, pyramids as (levels, packs, min res,
# max res), log2 table size, hidden, out, qbits)
QMLP_SHAPES = [("proposal", 1 << 21, [(5, 1, 16, 128)], 17, 16, 1, 8),
               ("nerfacto", 1 << 20, [(16, 1, 16, 2048)], 19, 64, 16, 8),
               ("sam", 1 << 18, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 256, 8),
               ("sam", 1 << 18, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 256, 4),
               ("clipseg", 8192, [(12, 4, 16, 128), (12, 4, 128, 512)], 19, 256, 192, 8)]


def _cameras(dev, size: int, focal: float):
    from samnerf_tpu_torch.core.cameras import Cameras
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:, 3] = [0.0, 0.0, 1.5]
    f = torch.tensor([[focal]], device=dev)
    c = torch.tensor([[size / 2.0]], device=dev)
    return Cameras(camera_to_worlds=torch.as_tensor(c2w[None], device=dev),
                   fx=f, fy=f, cx=c, cy=c, width=size, height=size)


def capture_frame_positions(dev, cfg=None, size: int = 512):
    """The positions one full-width ``size``² static frame (int8 fused,
    random weights from seed 0; ``cfg`` cuts the model) feeds each serve
    head, from the model's own forward: per head, its middle call of the
    frame (proposal and nerfacto run once per 32768-ray chunk, SAM twice,
    ClipSeg once).  The SAM head's positions are also those its two
    pyramids' Q-ENC calls take in an int8 frame."""
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.fields import nerfacto_field
    from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig, init_params

    cfg = dataclasses.replace(cfg or SAMModelConfig(hash_fn="morton"), hash_q8_serve=True,
                              serve_fuse_mlp=True)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0), device=dev))
    snr = SamNerfRenderer(model, serve_preset="static")
    snr.bake_serve_tables()
    calls = {}
    fused = nerfacto_field.parity_hash_encode_qmlp

    def record(tables, scales, positions, *args, **kw):
        out = fused(tables, scales, positions, *args, **kw)
        calls.setdefault(HEAD_BY_OUT[out.shape[1]], []).append(positions.clone())
        return out

    nerfacto_field.parity_hash_encode_qmlp = record
    try:
        snr.renderer.render_image_device(_cameras(dev, size, 400.0 * size / 512), 0,
                                         size, size, ("sam", "clipseg"), minimal=True)
    finally:
        nerfacto_field.parity_hash_encode_qmlp = fused
    frame = {head: c[len(c) // 2] for head, c in calls.items()}
    print("frame positions: " + ", ".join(f"{h} {len(calls[h])} calls, N={p.shape[0]}"
                                          for h, p in frame.items()), flush=True)
    return frame


def _time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def step_encodes(calls):
    """Of the encodes of a training step (``capture_step_encodes``), the
    first of each F32_SHAPES step shape, by name."""
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    out = {}
    for name, L, P, log2, _, lo, hi, where in F32_SHAPES:
        if where == "step":
            scalings = hash_grid_scalings(L, lo, hi)
            out[name] = next({k: c[k] for k in ("positions", "cotangent", "hash_fn")}
                             for c in calls if c["levels"] == L and c["packs"] == P
                             and c["num_steps"] == (1 << log2) // 1024
                             and np.allclose(c["scalings"], scalings))
    return out


def bench_f32(dev, frame_pos, step_enc):
    """Rows of (kernel, shape, positions, points, ms, max abs err or
    tolerance ratio against the plain version) of F32-ENC and, at the
    training shapes, F32-ENC-BWD."""
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, L, P, log2, n, lo, hi, where in F32_SHAPES:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo, hi).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        g = torch.randn((n, P * 2 * L), generator=gen, device=dev)
        g *= (torch.rand((n,), generator=gen, device=dev) >= 0.1)[:, None]
        cases = [("uniform", torch.rand((n, 3), generator=gen, device=dev), g, "morton")]
        if where == "frame":
            cases.append(("frame", frame_pos[FRAME_HEAD[name]], None, "morton"))
        else:
            c = step_enc[name]
            cases.append(("step", c["positions"], c["cotangent"], c["hash_fn"]))
        for positions, pos, cot, hash_fn in cases:
            run = lambda: hg.parity_hash_encode(table, pos, scalings, steps, hash_fn)
            ref = hg.parity_hash_encode_ref(table, pos, scalings, steps, hash_fn)
            rows.append(dict(kernel="F32-ENC", shape=name, positions=positions,
                             points=pos.shape[0], ms=_time_ms(run),
                             max_abs_err=(run() - ref).abs().max().item()))
            print(rows[-1], flush=True)
            if where == "frame":
                continue
            run = lambda: hg.parity_hash_encode_bwd(cot, pos, scalings, steps, hash_fn)
            ref = hg.parity_hash_encode_bwd_ref(cot, pos, scalings, steps, hash_fn)
            ratio = ((run() - ref).abs() / (1e-4 + 1e-2 * ref.abs())).max().item()
            rows.append(dict(kernel="F32-ENC-BWD", shape=name, positions=positions,
                             points=pos.shape[0], ms=_time_ms(run), tol_ratio=ratio))
            print(rows[-1], flush=True)
            del ref
        del table, g
    return rows


def bench(dev, frame_pos):
    """Rows of (kernel, shape, qbits, positions, points, ms, max abs err
    against the plain version) of Q-ENC and FUSED-QMLP for this process's
    ``samnerf_tpu_torch``."""
    from samnerf_tpu_torch.fields.mlp import MLP
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.ops.encodings import hash_grid_scalings

    def serve_layout(packed, levels):
        if hasattr(hg, "interleave_packs"):
            return hg.interleave_packs(packed, levels)
        return packed                       # a checkout before the serve layout

    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, L, P, log2, n, lo, hi, head, qbits in QENC_SHAPES:
        steps = (1 << log2) // 1024
        scalings = tuple(hash_grid_scalings(L, lo, hi).tolist())
        table = hg.init_parity_table(gen, L, steps, P, scale=0.5, device=dev)
        packed, scales = hg.quantize_parity_table(table, qbits=qbits)
        serve = serve_layout(packed, L)
        for where, pos in (("uniform", torch.rand((n, 3), generator=gen, device=dev)),
                           ("frame", frame_pos[head])):
            run = lambda: hg.parity_hash_encode_q8(serve, scales, pos, scalings, steps,
                                                   "morton", qbits)
            err = (run() - hg._parity_hash_encode_q8_ref(packed, scales, pos, scalings, steps,
                                                         "morton", qbits)).abs().max().item()
            rows.append(dict(kernel="Q-ENC", shape=name, qbits=qbits, positions=where,
                             points=pos.shape[0], ms=_time_ms(run), max_abs_err=err))
            print(rows[-1], flush=True)
        del table, packed, serve
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, n, spec, log2, h_dim, o_dim, qbits in QMLP_SHAPES:
        steps = (1 << log2) // 1024
        packed, scales, scalings = [], [], []
        for levels, packs, lo, hi in spec:
            table = hg.init_parity_table(gen, levels, steps, packs, scale=0.5, device=dev)
            pk, sc = hg.quantize_parity_table(table, qbits=qbits)
            packed.append(pk)
            scales.append(sc)
            scalings.append(tuple(hash_grid_scalings(levels, lo, hi).tolist()))
        serve = [serve_layout(pk, len(s)) for pk, s in zip(packed, scalings)]
        c_dim = sum(2 * p.shape[0] for p in packed)
        mlp = MLP(c_dim, h_dim, 1, o_dim, device=dev)
        with torch.no_grad():
            for layer in mlp.layers:
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen, device=dev)
                                   * layer.weight.shape[1] ** -0.5)
                layer.bias.copy_(torch.randn(layer.bias.shape, generator=gen, device=dev) * 0.1)
        w1, w2 = (m.weight.detach().t().contiguous() for m in mlp.layers)
        b1, b2 = (m.bias.detach() for m in mlp.layers)
        for where, pos in (("uniform", torch.rand((n, 3), generator=gen, device=dev)),
                           ("frame", frame_pos[name])):
            args = (scales, pos, scalings, steps, w1, b1, w2, b2, "morton", qbits)
            run = lambda: hg.parity_hash_encode_qmlp(serve, *args)

            @torch.no_grad()
            def unfused():
                return mlp(torch.cat([hg.parity_hash_encode_q8(t, sc, pos, s, steps, "morton",
                                                               qbits)
                                      for t, sc, s in zip(serve, scales, scalings)], -1))

            ref = hg._parity_hash_encode_qmlp_ref(packed, *args)
            err = (run() - ref).abs().max().item()
            rows.append(dict(kernel="FUSED-QMLP", shape=name, qbits=qbits, positions=where,
                             points=pos.shape[0], ms=_time_ms(run),
                             unfused_route_ms=_time_ms(unfused), max_abs_err=err))
            print(rows[-1], flush=True)
        del packed, serve, scales, mlp
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capture", help="write the frame positions to this file")
    ap.add_argument("--positions", help="time the kernels on these frame positions")
    ap.add_argument("--root", default=None, help="the checkout whose kernels to time")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--only", choices=("f32", "quantized"), default=None,
                    help="time only the f32 or only the quantized kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_encode: no CUDA device")
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
    if args.capture:
        from samnerf_tpu_torch.scripts.profile_train import capture_step_encodes
        frame = capture_frame_positions(dev)
        step = step_encodes(capture_step_encodes(dev))
        torch.save({"frame": {k: v.cpu() for k, v in frame.items()},
                    "step": {k: {f: (v.cpu() if torch.is_tensor(v) else v)
                                 for f, v in c.items()} for k, c in step.items()}},
                   args.capture)
        return
    from samnerf_tpu_torch.ops import cuda_build
    print(f"kernels of {Path(cuda_build.__file__).resolve().parents[2]}", flush=True)
    cuda_build.build_all()
    saved = torch.load(args.positions)
    frame = {k: v.to(dev) for k, v in saved["frame"].items()}
    rows = []
    if args.only != "quantized":
        step = {k: {f: (v.to(dev) if torch.is_tensor(v) else v) for f, v in c.items()}
                for k, c in saved["step"].items()}
        rows += bench_f32(dev, frame, step)
    if args.only != "f32":
        rows += bench(dev, frame)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"bench_encode_{args.tag}.json").write_text(
        json.dumps({"card": smi, "tag": args.tag, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
