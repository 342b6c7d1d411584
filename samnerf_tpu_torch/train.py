"""Training entry point of the port.

Counterpart of ``samnerf_tpu/train.py`` on one NVIDIA GPU: the
``samnerf_distill`` and ``samnerf_no_distill`` presets and the model zoo::

    python -m samnerf_tpu_torch.train samnerf_distill --data /path/to/scene \\
        [--trainer.max-num-iterations N] [--model.hash-fn reference] \\
        [--model.compute-dtype bfloat16] [--model.use-dino-feature True \\
        --datamanager.use-dino-feature True] ...
    python -m samnerf_tpu_torch.train instant-ngp --data /path/to/scene \\
        [--max-num-iterations 30000] [--rays-per-batch 4096] [--lr LR] \\
        [--output-dir outputs] [--seed 42] [--log-every 100]

``--data`` takes a nerfstudio, Blender or instant-ngp directory (routed
by ``data.datamanager._detect_parser``).

Data-parallel over several cards, one process each::

    torchrun --nproc-per-node N -m samnerf_tpu_torch.train samnerf_distill --data DIR

Every rank trains on its share of the same global batch
(:mod:`samnerf_tpu_torch.parallel.mesh`); the main process alone writes
the config, checkpoints and events and serves the viewer.

Writes ``config.json`` and ``samnerf_tpu_torch_ckpts/step-*.pt`` under
``<output_dir>/<scene>/<method>/<timestamp>/``, and the event writers that
``--vis`` names there (``json``: ``metrics.json``; ``tensorboard``;
``wandb``).  The ``viewer`` token (the presets' default) attaches the
interactive viewer to the run: open ``http://localhost:7008/?port=7007``
(``--websocket-port``, ``--http-port``); ``--vis json`` trains without
it.  When the viewer cannot start, training goes on headless with a
notice.  Evaluate a run with
``python -m samnerf_tpu_torch.scripts.eval <run_dir>``.

A zoo method (:func:`samnerf_tpu_torch.configs.zoo.zoo_methods`:
vanilla-nerf, mipnerf, instant-ngp, tensorf, depth-nerfacto,
semantic-nerfw, nerfplayer-nerfacto, nerfplayer-ngp) trains through
:func:`train_zoo` with the JAX ``train_zoo``'s options: an rgb loop (with
the depth or semantic channel for depth-nerfacto and semantic-nerfw,
read from ``depths/`` or ``semantics/`` beside ``images/``) in chunks
of the method's ``dispatch_chunk`` steps (16, or 2 for the nerfplayer
methods; on the card one CUDA graph replay a chunk), the iteration count
rounded up to a whole chunk, the occupancy grid of the ngp methods, one
checkpoint at the end
(``<output_dir>/<scene>/<method>/<timestamp>/samnerf_tpu_torch_ckpts/``)
and the PSNR of eval view 0.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import time
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from samnerf_tpu_torch.configs.cli import apply_overrides
from samnerf_tpu_torch.configs.methods import MethodConfig, method_configs
from samnerf_tpu_torch.utils import writer


def parse(argv: List[str]) -> MethodConfig:
    """``<method> [--dotted.option value ...]`` -> the preset with its
    overrides applied.  Help exits 0, an unknown method 2."""
    from samnerf_tpu_torch.configs.zoo import zoo_methods

    registry = method_configs()
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(registry), "| zoo:", ", ".join(zoo_methods()))
        raise SystemExit(0)
    if argv[0] not in registry:
        print(f"unknown method {argv[0]!r}; available: {', '.join(registry)}"
              f" | zoo: {', '.join(zoo_methods())}")
        raise SystemExit(2)
    return apply_overrides(registry[argv[0]], argv[1:])


def save_config(config: MethodConfig) -> None:
    out = Path(config.trainer.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    def enc(o):
        if dataclasses.is_dataclass(o):
            return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        return str(o)

    (out / "config.json").write_text(json.dumps(enc(config), indent=2))


def train_loop(config: MethodConfig, device="cuda", step_callback=None,
               num_devices: Optional[int] = None):
    """Seed, build the data and the trainer, set up ``config.vis``, train
    (``step_callback(step, metrics)`` after each dispatch, a block of
    ``steps_per_dispatch`` steps or a single step, after the viewer's
    own), and stop the viewer when training ends.  ``num_devices``: the
    ranks the run expects (None: the process group's, 1 without one); a
    run on another number raises ValueError.  Writers and the viewer run
    on the main process only."""
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import Trainer
    from samnerf_tpu_torch.parallel import mesh

    if num_devices is not None and num_devices != mesh.world_size():
        raise ValueError(f"num_devices={num_devices}, but the process group has "
                         f"{mesh.world_size()} ranks")

    seed = config.trainer.seed
    random.seed(seed)
    np.random.seed(seed)
    dm = DataManager(config.datamanager, seed=seed)
    config.model = dataclasses.replace(config.model, num_images=dm.num_train_images)
    trainer = Trainer(config.model, config.trainer, config.optimizers, dm,
                      device=device)
    if mesh.is_main_process():
        viewer = _setup_vis(config, trainer)
    else:
        writer.reset()
        viewer = None
    callbacks = [cb for cb in (viewer and viewer.step_callback, step_callback) if cb]

    def on_step(step, metrics):
        for cb in callbacks:
            cb(step, metrics)

    try:
        trainer.train(step_callback=on_step if callbacks else None)
    finally:
        if viewer is not None:
            viewer.stop()
    return trainer


def _setup_vis(config: MethodConfig, trainer=None):
    """One event writer per ``tensorboard``, ``wandb`` or ``json`` token
    of ``config.vis``, writing under the run's output directory (the
    previous run's writers are flushed and dropped first); with a
    ``viewer`` token, the viewer attached to ``trainer``
    (:func:`_launch_viewer`).  Returns the running ``ViewerState`` or
    None; a viewer that cannot start prints a notice and gives None."""
    writer.reset()
    vis = (config.vis or "").lower()
    out = Path(config.trainer.output_dir)
    for kind in ("tensorboard", "wandb", "json"):
        if kind in vis:
            writer.setup_event_writer(kind, out)
    if "viewer" not in vis or trainer is None:
        return None
    try:
        return _launch_viewer(trainer, config)
    except Exception as e:      # no free port, a missing package, no SAM weights
        print(f"viewer unavailable ({e}); training continues headless")
        return None


def _sam_for_viewer(device):
    """SAM for the viewer's mask decode: the checkpoint named by
    ``$SAM_CHECKPOINT`` or found under ``./checkpoints/``, else a decoder
    with seeded weights (with a notice)."""
    from samnerf_tpu_torch.perception.sam.build_sam import build_sam
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params

    ckpt = os.environ.get("SAM_CHECKPOINT")
    if not (ckpt and Path(ckpt).exists()):
        ckpt = next((c for c in ("checkpoints/sam_vit_h_4b8939.pth",
                                 "checkpoints/sam_vit_b_01ec64.pth") if Path(c).exists()),
                    None)
    if ckpt is not None:
        return build_sam("vit_h" if "vit_h" in ckpt else "vit_b", checkpoint=ckpt,
                         device=device)
    print("viewer: no SAM checkpoint found ($SAM_CHECKPOINT or ./checkpoints/): "
          "mask decode uses seeded random weights")
    sam = Sam(device=device)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(1), device=device))
    return sam


def _launch_viewer(trainer, config: MethodConfig):
    """Attach the interactive viewer to a training run: a renderer over
    the trainer's model (``static`` preset, a SAM predictor), the
    websocket server on ``config.websocket_port`` and the client's HTTP
    server on ``config.http_port`` (0: free ports), the scene and the
    training cameras sent; frames render under the trainer's
    ``train_lock``.  Returns the started ``ViewerState``."""
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.viewer.server import serve_client
    from samnerf_tpu_torch.viewer.viewer_state import ViewerState

    renderer = SamNerfRenderer(trainer.model,
                               sam_predictor=SamPredictor(_sam_for_viewer(trainer.device)),
                               serve_preset="static")
    dm = trainer.datamanager
    state = ViewerState(renderer, cameras=dm.cameras, port=config.websocket_port,
                        train_lock=trainer.train_lock,
                        save_checkpoint_fn=trainer.save_checkpoint)
    state.camera_paths_dir = str(Path(config.trainer.output_dir) / "camera_paths")
    state.start()
    try:
        state.init_scene(cameras=dm.cameras, images=dm.images,
                         config_base_dir=str(config.trainer.output_dir),
                         data_base_dir=str(config.datamanager.dataparser.data),
                         export_path_name=Path(str(config.trainer.output_dir)).stem)
        state.http = serve_client(http_port=config.http_port)
    except BaseException:
        state.stop()
        raise
    print(f"viewer: http://localhost:{state.http.server_address[1]}/"
          f"?port={state.server.port}", flush=True)
    return state


OCC_RES = 64
OCC_WARMUP = 256
OCC_EVERY = 16
"""The zoo's occupancy schedule (the JAX ``train_zoo``'s): a 64^3 grid,
all ones until it is first updated, then an update with ``res**3 // 4``
samples before each chunk of steps from s (counted from 1) with s > 256
and (s - 1) % 16 < the chunk's length: for chunks of 1, 2 or 16 steps,
before each step s with s > 256 and (s - 1) % 16 == 0."""
EVAL_CHUNK = 4096


def occupancy_update_due(step: int, chunk: int = 1) -> bool:
    """Is the grid updated before the ``chunk`` steps from ``step``
    (counted from 1)?"""
    return step > OCC_WARMUP and (step - 1) % OCC_EVERY < chunk


@dataclasses.dataclass
class ZooRun:
    """What :func:`train_zoo` did: the trained model, the run directory,
    the checkpoint, the last step's metrics (floats), each grid update's
    (step, occupied share), the grid (None without one), the eval PSNR and
    the eval render's ms (None without eval images)."""
    model: torch.nn.Module
    out_dir: Path
    checkpoint: Path
    metrics: dict
    occupancy_updates: list
    occupancy: Optional[torch.Tensor]
    psnr: Optional[float]
    eval_ms: Optional[float]
    steps_by_dispatch: Optional[dict] = None
    """The steps run eagerly, captured and replayed
    (:func:`~samnerf_tpu_torch.configs.zoo.make_zoo_train_chunk`)."""


def _zoo_datamanager(name: str, dm_cfg, seed: int):
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.data.datamanagers_extra import (DepthDataManager,
                                                           SemanticDataManager)
    if name == "depth-nerfacto":
        return DepthDataManager(dm_cfg, seed=seed)
    if name == "semantic-nerfw":
        return SemanticDataManager(dm_cfg, seed=seed)
    return DataManager(dm_cfg, seed=seed)


def render_eval_rgb(model, cameras, image_index: int = 0, chunk: int = EVAL_CHUNK,
                    **kwargs) -> torch.Tensor:
    """rgb [H, W, 3] of one camera of ``cameras``, rendered ``chunk`` rays
    at a time in eval mode (``kwargs`` go to the model: the grid)."""
    from samnerf_tpu_torch.core.cameras import generate_rays
    from samnerf_tpu_torch.engine.eval_render import _chunked_coords

    h, w = cameras.height, cameras.width
    device = cameras.camera_to_worlds.device
    coords = torch.as_tensor(_chunked_coords(h, w, chunk), device=device)
    ci = torch.full((chunk,), image_index, dtype=torch.long, device=device)
    rgb = torch.cat([model(generate_rays(cameras, ci, c), train=False, **kwargs)["rgb"]
                     for c in coords])
    return rgb[:h * w].reshape(h, w, 3)


def zoo_arg_parser(name: str):
    """The JAX ``train_zoo``'s options."""
    import argparse

    ap = argparse.ArgumentParser(prog=f"samnerf_tpu_torch.train {name}")
    ap.add_argument("--data", required=True)
    ap.add_argument("--max-num-iterations", type=int, default=30000,
                    help="rounded up to a multiple of the method's dispatch chunk")
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=None,
                    help="override the per-method default lr")
    ap.add_argument("--output-dir", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--log-every", type=int, default=100,
                    help="quantized to the method's dispatch chunk")
    return ap


@dataclasses.dataclass
class ZooSetup:
    """A zoo method ready to train from its seed (:func:`setup_zoo`): the
    model and its config, the datamanager, the cameras, the batch generator
    and the optimizer on the device, ``sample()`` (a training batch drawn
    on the device from the generator), ``run_chunk`` (the method's
    :func:`~samnerf_tpu_torch.configs.zoo.make_zoo_train_chunk`), and for
    the ngp methods the grid (the chunk's static input), its density EMA,
    box and generator (:meth:`update_grid`)."""
    method: Any
    model: torch.nn.Module
    config: Any
    datamanager: Any
    cameras: Any
    generator: torch.Generator
    optimizer: Any
    sample: Callable
    run_chunk: Callable
    occupancy: Optional[torch.Tensor] = None
    grid_density: Optional[torch.Tensor] = None
    occ_aabb: Optional[torch.Tensor] = None
    occ_generator: Optional[torch.Generator] = None

    def update_grid(self) -> float:
        """One grid update (eagerly, between chunks), written into the
        grid in place; returns its occupied share."""
        from samnerf_tpu_torch.ops.occupancy import update_occupancy

        self.grid_density, grid = update_occupancy(
            self.grid_density, self.model.density_fn, self.occ_aabb, self.occ_generator,
            num_samples=OCC_RES ** 3 // 4)
        self.occupancy.copy_(grid)
        return float(self.occupancy.mean())


def setup_zoo(name: str, args, device="cuda") -> ZooSetup:
    """The model, data, optimizer, grid and chunk of :func:`train_zoo`,
    from ``args`` (:func:`zoo_arg_parser`'s)."""
    from samnerf_tpu_torch.configs.zoo import (init_zoo_params, make_zoo_train_chunk,
                                               zoo_methods, zoo_optimizer)
    from samnerf_tpu_torch.data.datamanager import DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.data.device_data import build_device_dataset, sample_batch

    device = torch.device(device)
    method = zoo_methods()[name]
    model, cfg = method.build(device=device)
    model.load_state_dict(init_zoo_params(model, torch.Generator().manual_seed(args.seed),
                                          device))
    data = Path(args.data)
    split = (not (data / "transforms.json").exists()
             and (data / "transforms_train.json").exists())
    dm = _zoo_datamanager(name, DataManagerConfig(
        dataparser=DataparserConfig(data=data, train_val_json_split=split),
        train_num_rays_per_batch=args.rays_per_batch), args.seed)
    cameras = dm.cameras.to(device)
    device_data = build_device_dataset(dm, device)
    hw = (dm.cameras.height, dm.cameras.width)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    optimizer = zoo_optimizer(model, args.lr if args.lr is not None else method.lr)
    occ = {}
    if method.use_occupancy:
        occ = dict(occupancy=torch.ones((OCC_RES,) * 3, device=device),
                   grid_density=torch.zeros((OCC_RES ** 3,), device=device),
                   occ_aabb=(model.aabb if hasattr(model, "aabb") else torch.tensor(
                       [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device=device)),
                   occ_generator=torch.Generator(device=device).manual_seed(
                       args.seed + 0x0CC))
    def sample():
        return sample_batch(generator, device_data, args.rays_per_batch, 1, hw)

    run_chunk = make_zoo_train_chunk(method, model, cfg, optimizer, cameras, sample, generator,
                                     method.dispatch_chunk, occ.get("occupancy"))
    return ZooSetup(method=method, model=model, config=cfg, datamanager=dm,
                    cameras=cameras, generator=generator, optimizer=optimizer, sample=sample,
                    run_chunk=run_chunk, **occ)


def train_zoo(name: str, argv: List[str], device="cuda",
              step_callback: Optional[Callable[[int, dict], None]] = None) -> ZooRun:
    """Train zoo method ``name`` end to end with the JAX ``train_zoo``'s
    options (``argv``) and loop: the iteration count rounded up to a
    multiple of the method's ``dispatch_chunk``, then one dispatch per
    chunk (:func:`make_zoo_train_chunk`: on the card one graph replay),
    batches drawn on the device, the occupancy grid updated between
    chunks on :data:`OCC_RES`'s schedule for the ngp methods, the loss
    printed every ``--log-every`` steps quantized to the chunk, a
    checkpoint at the end, the PSNR of eval view 0 rendered in 4096-ray
    chunks (with the grid), then the process's F32-ENC and F32-ENC-BWD
    launches (a capture counts once, a replay not at all).  ``step_callback(step, metrics)`` runs after
    each chunk with its last step and that step's metrics, and the grid's
    occupied share as ``metrics["occupied"]`` after a chunk the grid was
    updated before."""
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR
    from samnerf_tpu_torch.ops import hash_grid as hg
    from samnerf_tpu_torch.utils.metrics import psnr

    args = zoo_arg_parser(name).parse_args(argv)
    device = torch.device(device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    zs = setup_zoo(name, args, device)
    model, optimizer, dm, data = zs.model, zs.optimizer, zs.datamanager, Path(args.data)
    occ_kw = {} if zs.occupancy is None else {"occupancy": zs.occupancy}
    chunk = zs.method.dispatch_chunk
    n_chunks = -(-args.max_num_iterations // chunk)
    num_steps = n_chunks * chunk

    t0 = time.time()
    metrics, updates = {}, []
    for c in range(n_chunks):
        start = c * chunk + 1
        occupied = None
        if zs.occupancy is not None and occupancy_update_due(start, chunk):
            occupied = zs.update_grid()
            updates.append((start, occupied))
        metrics = zs.run_chunk()
        step = start + chunk - 1
        if occupied is not None:
            metrics["occupied"] = occupied
        # JAX's cadence, quantized to the chunk: every log_every // chunk
        # chunks, and the last
        if (step // chunk) % max(1, args.log_every // chunk) == 0 or c == n_chunks - 1:
            print(f"step {step}: loss={float(metrics['total_loss']):.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if step_callback is not None:
            step_callback(step, metrics)

    out = Path(args.output_dir) / data.name / name / time.strftime("%Y-%m-%d_%H%M%S")
    ckpt_dir = out / CKPT_DIR
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    checkpoint = ckpt_dir / f"step-{num_steps:09d}.pt"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": num_steps, "method": name, **occ_kw}, checkpoint)

    p = eval_ms = None
    if dm.eval_images is not None:
        t1 = time.perf_counter()
        rgb = render_eval_rgb(model, dm.eval_cameras.to(device), 0, **occ_kw)
        gt = torch.as_tensor(dm.eval_images[0], device=device).float() / 255.0
        p = float(psnr(rgb, gt))
        eval_ms = (time.perf_counter() - t1) * 1e3
        print(f"eval view 0 PSNR: {p:.2f}; saved {out}", flush=True)
    else:
        print(f"no eval images, no PSNR; saved {out}", flush=True)
    print(f"hash kernel launches: F32-ENC {hg.parity_hash_encode.launches}, "
          f"F32-ENC-BWD {hg.parity_hash_encode_bwd.launches}", flush=True)
    return ZooRun(model=model, out_dir=out, checkpoint=checkpoint,
                  metrics={k: float(v) for k, v in metrics.items()},
                  occupancy_updates=updates, occupancy=occ_kw.get("occupancy"), psnr=p,
                  eval_ms=eval_ms, steps_by_dispatch=dict(zs.run_chunk.steps_by_dispatch))


def main(argv=None, device="cuda",
         step_callback: Optional[Callable[[int, dict], None]] = None,
         run_callback: Optional[Callable[[ZooRun], None]] = None) -> int:
    """The command line, on ``device``: a zoo method runs :func:`train_zoo`
    (``step_callback`` after each chunk, ``run_callback`` with its
    :class:`ZooRun`), a preset :func:`train_loop` (``step_callback`` after
    each dispatch).  Returns 1 when ``device`` is a card and there is none."""
    from samnerf_tpu_torch.configs.zoo import zoo_methods

    from samnerf_tpu_torch.parallel import mesh

    argv = list(sys.argv[1:] if argv is None else argv)
    zoo = bool(argv) and argv[0] in zoo_methods()
    config = None if zoo else parse(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("samnerf_tpu_torch.train: no CUDA device", file=sys.stderr)
        return 1
    if zoo:
        run = train_zoo(argv[0], argv[1:], device=device, step_callback=step_callback)
        if run_callback is not None:
            run_callback(run)
        return 0
    started = not mesh.is_initialized() and mesh.initialize_distributed(device=device)
    try:
        if mesh.is_initialized() and str(device) == "cuda":
            device = torch.device("cuda", mesh.local_rank())
        config.trainer.output_dir = (Path(config.trainer.output_dir)
                                     / Path(config.datamanager.dataparser.data).name
                                     / config.method_name
                                     / time.strftime("%Y-%m-%d_%H%M%S"))
        if mesh.is_main_process():
            save_config(config)
        train_loop(config, device=device, step_callback=step_callback)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
