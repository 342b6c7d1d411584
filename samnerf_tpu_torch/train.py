"""Training entry point of the port.

Counterpart of ``samnerf_tpu/train.py`` for the ``samnerf_distill`` and
``samnerf_no_distill`` presets on one NVIDIA GPU::

    python -m samnerf_tpu_torch.train samnerf_distill --data /path/to/scene \\
        [--trainer.max-num-iterations N] [--model.hash-fn reference] \\
        [--model.compute-dtype bfloat16] [--model.use-dino-feature True \\
        --datamanager.use-dino-feature True] ...

``--data`` takes a nerfstudio, Blender or instant-ngp directory (routed
by ``data.datamanager._detect_parser``).

Writes ``config.json`` and ``samnerf_tpu_torch_ckpts/step-*.pt`` under
``<output_dir>/<scene>/<method>/<timestamp>/``, and the event writers that
``--vis`` names there (``json``: ``metrics.json``; ``tensorboard``;
``wandb``).  The ``viewer`` token (the presets' default) attaches the
interactive viewer to the run: open ``http://localhost:7008/?port=7007``
(``--websocket-port``, ``--http-port``); ``--vis json`` trains without
it.  When the viewer cannot start, training goes on headless with a
notice.  The model zoo waits.  Evaluate a run with
``python -m samnerf_tpu_torch.scripts.eval <run_dir>``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from samnerf_tpu_torch.configs.cli import apply_overrides
from samnerf_tpu_torch.configs.methods import MethodConfig, method_configs
from samnerf_tpu_torch.utils import writer


def parse(argv: List[str]) -> MethodConfig:
    """``<method> [--dotted.option value ...]`` -> the preset with its
    overrides applied.  Help exits 0, an unknown method 2."""
    registry = method_configs()
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(registry))
        raise SystemExit(0)
    if argv[0] not in registry:
        print(f"unknown method {argv[0]!r}; available: {', '.join(registry)}")
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


def train_loop(config: MethodConfig, device="cuda", step_callback=None):
    """Seed, build the data and the trainer, set up ``config.vis``, train
    (``step_callback(step, metrics)`` after each step, after the viewer's
    own), and stop the viewer when training ends."""
    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import Trainer

    seed = config.trainer.seed
    random.seed(seed)
    np.random.seed(seed)
    dm = DataManager(config.datamanager, seed=seed)
    config.model = dataclasses.replace(config.model, num_images=dm.num_train_images)
    trainer = Trainer(config.model, config.trainer, config.optimizers, dm,
                      device=device)
    viewer = _setup_vis(config, trainer)
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    config = parse(argv)
    if not torch.cuda.is_available():
        print("samnerf_tpu_torch.train: no CUDA device", file=sys.stderr)
        return 1
    config.trainer.output_dir = (Path(config.trainer.output_dir)
                                 / Path(config.datamanager.dataparser.data).name
                                 / config.method_name / time.strftime("%Y-%m-%d_%H%M%S"))
    save_config(config)
    train_loop(config)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
