"""Diagnose the zoo's hash methods (instant-ngp, depth-nerfacto,
semantic-nerfw) on ``validate_zoo``'s textured scene, on the card.

    python3 -m samnerf_tpu_torch.scripts.zoo_diagnose routes [--steps 2000]
    python3 -m samnerf_tpu_torch.scripts.zoo_diagnose replay RUN.pt ... \\
        [--variants jax,port_draws,port_batches,port_init]

- ``routes``: each method through the train entry at 64 + 2 views of
  128x128, 4096 rays a step, once through the hand-written kernels
  (F32-ENC, F32-ENC-BWD) and once with their plain versions in their
  place.
- ``replay``: a JAX run exported on the CPU by
  ``tests/export_zoo_replay.py`` (JAX's init, pixels, sampler jitter and
  losses) through the port's step (:func:`replay`).

Every run reports the PSNR of eval view 0 and of train view 0 and the
renders' mean colours.  Writes ``chiprun_out/zoo_diag_<mode>.json``.
Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from samnerf_tpu_torch import train as T
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.ops import cuda_build, hash_grid as hg
from samnerf_tpu_torch.utils.metrics import psnr
from samnerf_tpu_torch.utils.synthetic import write_textured_scene

ROUTES = (("instant-ngp", ("kernel", "plain")), ("depth-nerfacto", ("kernel", "plain")),
          ("semantic-nerfw", ("kernel",)))
LOSS_STEPS = (1, 10, 100, 500, 1000, 2000, 4000, 8000)


def scene_for(root: Path, views: int, res: int) -> Path:
    scene = root / f"scene_{views}_{res}"
    if not (scene / "transforms_test.json").exists():
        write_textured_scene(scene, num_train=views, num_test=2, h=res, w=res, detail=2.0)
    return scene


def view_report(model, scene: Path, dev, occupancy=None) -> dict:
    """PSNR and mean colour of eval view 0 and train view 0."""
    dm = DataManager(DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True)))
    kw = {} if occupancy is None else {"occupancy": occupancy}
    out = {}
    for split, cams, imgs in (("test", dm.eval_cameras, dm.eval_images),
                              ("train", dm.cameras, dm.images)):
        gt = torch.as_tensor(imgs[0], device=dev).float() / 255.0
        rgb = T.render_eval_rgb(model, cams.to(dev), 0, **kw)
        out[f"{split}_psnr"] = float(psnr(rgb, gt))
        out[f"{split}_rgb_mean"] = rgb.mean((0, 1)).tolist()
        out[f"{split}_gt_mean"] = gt.mean((0, 1)).tolist()
    return out


def plain_encodes(on: bool, kernels=(hg.parity_hash_encode, hg.parity_hash_encode_bwd)):
    """Route the plain versions in place of the kernels (the wrappers are
    module globals that the autograd function calls), or back."""
    def fwd(t, p, s, n, h="reference"):
        return hg.parity_hash_encode_ref(t, p, s, n, h)

    def bwd(g, p, s, n, h="reference"):
        return hg.parity_hash_encode_bwd_ref(g, p, s, n, h)

    fwd.launches = bwd.launches = 0     # the train entry prints the wrappers' counts
    hg.parity_hash_encode, hg.parity_hash_encode_bwd = (fwd, bwd) if on else kernels


def entry_run(name: str, scene: Path, steps: int, rays: int, dev, work: Path) -> dict:
    """``name`` through ``train.main`` on ``dev``: the losses of the chunks
    that reach each of ``LOSS_STEPS`` (the callback runs once a chunk, at
    its last step) and of the last."""
    losses, runs, last = {}, [], [0]

    def on_step(step, m):
        if any(last[0] < s <= step for s in LOSS_STEPS) or step >= steps:
            losses[step] = {k: float(v) for k, v in m.items()}
        last[0] = step

    t0 = time.time()
    rc = T.main([name, "--data", str(scene), "--max-num-iterations", str(steps),
                 "--rays-per-batch", str(rays), "--output-dir", str(work / "runs"),
                 "--log-every", str(steps)],
                device=dev, step_callback=on_step, run_callback=runs.append)
    run = runs[0]
    out = {"rc": rc, "seconds": time.time() - t0, "eval_psnr": run.psnr, "losses": losses,
           "occupancy_updates": len(run.occupancy_updates)}
    with torch.no_grad():
        out.update(view_report(run.model, scene, dev, run.occupancy))
    return out


def model_draws(model, num_rays: int, generator: torch.Generator, device) -> dict:
    """The nerfacto backbone's random inputs of one training render."""
    backbone = getattr(model, "backbone", model)
    return {"jitter": backbone.draw_jitter(num_rays, generator, device)}


def _to(d, dev):
    if isinstance(d, dict):
        return {k: _to(v, dev) for k, v in d.items()}
    if isinstance(d, (tuple, list)):
        return tuple(_to(v, dev) for v in d)
    return d.to(dev)


class Loop:
    """The train entry's loop for depth-nerfacto or semantic-nerfw on one
    device, one step at a time, its batches and draws given by the
    caller."""

    def __init__(self, name: str, scene: Path, rays: int, dev, seed: int = 42, state=None):
        from samnerf_tpu_torch.configs.zoo import (init_zoo_params, make_zoo_train_step,
                                                   zoo_methods, zoo_optimizer)
        from samnerf_tpu_torch.data.device_data import build_device_dataset

        self.dev = torch.device(dev)
        method = zoo_methods()[name]
        self.model, cfg = method.build(device=self.dev)
        self.model.load_state_dict(state if state is not None else init_zoo_params(
            self.model, torch.Generator().manual_seed(seed), self.dev))
        dm = T._zoo_datamanager(name, DataManagerConfig(
            dataparser=DataparserConfig(data=scene, train_val_json_split=True),
            train_num_rays_per_batch=rays), seed)
        self.cameras = dm.cameras.to(self.dev)
        self.data = build_device_dataset(dm, self.dev)
        self.step_fn = make_zoo_train_step(method, self.model, cfg,
                                           zoo_optimizer(self.model, method.lr))

    def step(self, indices: torch.Tensor, draws: dict) -> dict:
        from samnerf_tpu_torch.data.device_data import gather_batch

        hw = self.data["images"].shape[1:3]
        batch = gather_batch(self.data, indices.to(self.dev), 1, hw)
        return self.step_fn(self.cameras, batch, None, None, _to(draws, self.dev))


REPLAY_VARIANTS = ("jax", "port_draws", "port_batches", "port_init")


def replay(path: Path, dev, variants, root: Path) -> dict:
    """A JAX run exported by ``tests/export_zoo_replay.py`` (JAX's
    init, per-step pixel indices and sampler jitter, and JAX's per-step
    losses) replayed through the port's step on ``dev``: ``jax`` takes all
    three from the file, ``port_draws`` the port's own jitter,
    ``port_batches`` the port's own pixels, ``port_init`` the port's own
    init (``--seed``'s); the port's draws come from a generator on
    ``dev``.  Per variant: the losses every 16 steps beside JAX's, the
    largest relative loss difference over the first 16 steps, and the
    PSNR of eval view 0 and train view 0."""
    from samnerf_tpu_torch.data.device_data import sample_indices

    run = torch.load(path, map_location="cpu")
    name, rays, seed = run["method"], run["rays"], run["seed"]
    scene = scene_for(root, run["views"], run["res"])
    steps = run["indices"].shape[0]
    out = {"method": name, "views": run["views"], "res": run["res"], "rays": rays,
           "seed": seed, "steps": steps, "jax_eval_psnr": run["jax_eval_psnr"],
           "jax_losses": {s: run["jax_metrics"][s - 1] for s in range(16, steps + 1, 16)}}
    for variant in variants:
        loop = Loop(name, scene, rays, dev, seed,
                    state=None if variant == "port_init" else run["init"])
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        n, h, w = loop.data["images"].shape[:3]
        losses, first = {}, 0.0
        t0 = time.time()
        for s in range(1, steps + 1):
            idx = (sample_indices(gen, rays, n, h, w, 1, device=dev)
                   if variant == "port_batches" else run["indices"][s - 1].long())
            draws = (model_draws(loop.model, rays, gen, dev) if variant == "port_draws"
                     else {"jitter": tuple(run["jitter"][s - 1])})
            m = loop.step(idx, draws)
            if s <= 16:
                ref = run["jax_metrics"][s - 1]
                first = max(first, max(abs(float(m[k]) / ref[k] - 1.0) for k in ref
                                       if abs(ref[k]) > 1e-6))
            if s % 16 == 0:
                losses[s] = {k: float(v) for k, v in m.items()}
        res = {"seconds": time.time() - t0, "losses": losses,
               "first16_max_rel_loss_diff": first}
        with torch.no_grad():
            res.update(view_report(loop.model, scene, loop.dev))
        out[variant] = res
        print(variant, json.dumps({k: v for k, v in res.items() if k != "losses"}),
              flush=True)
        del loop
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="samnerf_tpu_torch.scripts.zoo_diagnose")
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("routes")
    r.add_argument("--steps", type=int, default=2000)
    rp = sub.add_parser("replay")
    rp.add_argument("runs", nargs="+", help="files written by tests/export_zoo_replay.py")
    rp.add_argument("--variants", default=",".join(REPLAY_VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("samnerf_tpu_torch.scripts.zoo_diagnose: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        if args.mode == "routes":
            scene = scene_for(root, 64, 128)
            for name, routes in ROUTES:
                for route in routes:
                    plain_encodes(route == "plain")
                    results[f"{name}/{route}"] = entry_run(name, scene, args.steps, 4096,
                                                           dev, root)
                    print(name, route, json.dumps(results[f"{name}/{route}"]), flush=True)
                    torch.cuda.empty_cache()
            plain_encodes(False)
        else:
            for path in args.runs:
                results[Path(path).stem] = replay(Path(path), dev,
                                                  args.variants.split(","), root)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path(f"chiprun_out/zoo_diag_{args.mode}.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
