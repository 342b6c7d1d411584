"""Rank functions for ``test_torch_dist.py``, run in spawned processes.

This module imports torch and the port only, so a spawned rank starts
without JAX.  :func:`run_ranks` starts ``world`` processes on a gloo
process group at a free local TCP port, each calling one function of this
module with the same payload, and returns every rank's result in rank
order; each process is joined with a timeout of its own and killed if it
hangs, and a rank that failed fails the caller with its traceback.
"""
from __future__ import annotations

import multiprocessing
import queue as queue_lib
import socket
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn_name: str, payload, results) -> None:
    torch.set_num_threads(1)
    from samnerf_tpu_torch.parallel import mesh
    try:
        mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        try:
            results.put((rank, "ok", globals()[fn_name](payload)))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(fn_name: str, payload, world: int = 2, timeout: float = TIMEOUT_S) -> List[Any]:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn_name, payload, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    try:
        for _ in range(world):
            rank, status, value = results.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    except queue_lib.Empty:
        raise TimeoutError(f"{fn_name}: ranks {sorted(set(range(world)) - set(got))} "
                           f"gave no result in {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    return [got[r] for r in range(world)]


def _tensors(d: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _numpy(d) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def train_step(payload):
    """One data-parallel step of ``make_train_step(..., distributed=True)``
    on this rank's share of the payload's global batch and jitter: the
    averaged metrics and gradients, and the new parameters."""
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.optimizers import OptimizerGroupConfig, build_optimizer
    from samnerf_tpu_torch.engine.trainer import TrainState, make_train_step
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.parallel import mesh

    model = SAMModel(payload["cfg"], device="cpu")
    model.load_state_dict(_tensors(payload["params"]))
    optimizer = build_optimizer({g: OptimizerGroupConfig() for g in payload["groups"]},
                                model)
    step = make_train_step(model, payload["cfg"], optimizer, payload["features"],
                           distributed=mesh.is_initialized())
    batch = {k: mesh.shard(v) for k, v in _tensors(payload["batch"]).items()}
    jitter = [mesh.shard(torch.from_numpy(j)) for j in payload["jitter"]]
    metrics = step(TrainState(*payload["state"]), Cameras(**_tensors(payload["cameras"]),
                                                         **payload["size"]),
                   batch, jitter=jitter)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "params": _numpy(model.state_dict())}


def trainer_run(payload):
    """``Trainer`` for a few steps on a scene: the final state, the loop's
    step, every step's losses, and the checkpoints this rank wrote."""
    import dataclasses
    from pathlib import Path

    from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.engine.optimizers import OptimizerGroupConfig
    from samnerf_tpu_torch.engine.trainer import CKPT_DIR, Trainer, TrainerConfig
    from samnerf_tpu_torch.parallel import mesh

    dm = DataManager(DataManagerConfig(
        dataparser=DataparserConfig(data=Path(payload["scene"]), train_val_json_split=True),
        train_num_rays_per_batch=payload["rays"], patch_size=payload["cfg"].patch_size,
        distill_sam=True, use_clipseg_feature=True))
    out = Path(payload["out"]) / f"rank{mesh.rank()}"
    cfg = TrainerConfig(max_num_iterations=payload["steps"], steps_per_save=100000,
                        log_every=1, steps_per_eval_batch=payload["eval_every"],
                        steps_per_eval_image=100000, output_dir=out)
    groups = {g: OptimizerGroupConfig() for g in payload["groups"]}
    model_cfg = dataclasses.replace(payload["cfg"], num_images=dm.num_train_images)
    trainer = Trainer(model_cfg, cfg, groups, dm, device="cpu")
    trainer.train()
    return {"params": _numpy(trainer.model.state_dict()), "step": trainer.state.step,
            "losses": [m for _, m in trainer.metrics_history if "total_loss" in m],
            "checkpoints": sorted(p.name for p in (out / CKPT_DIR).glob("*.pt"))
            if (out / CKPT_DIR).exists() else []}


def sharded_frame(payload):
    """``build_sharded_frame_fn`` with a SAM decode on this rank's share."""
    from samnerf_tpu_torch.core.cameras import Cameras
    from samnerf_tpu_torch.engine.eval_render import build_sharded_frame_fn
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.perception.sam.sam import Sam

    model = SAMModel(payload["cfg"], device="cpu")
    model.load_state_dict(_tensors(payload["params"]))
    sam = Sam(device="cpu")
    sam.load_state_dict(_tensors(payload["decoder"]))
    renderer = SamNerfRenderer(model, chunk=payload["chunk"], serve_preset="static").renderer
    h, w = payload["size"]["height"], payload["size"]["width"]
    frame = build_sharded_frame_fn(renderer, h, w, ("sam", "clipseg"), sam=sam)
    cams = Cameras(**_tensors(payload["cameras"]), **payload["size"])
    out = frame(cams, 0, torch.from_numpy(payload["coords"]),
                torch.from_numpy(payload["labels"]))
    return _numpy(out)


def all_reduce_grads(payload):
    """This rank's seeded gradients (parameter ``payload["no_grad"]``
    without one) before and after ``mesh.all_reduce_grads``."""
    from samnerf_tpu_torch.parallel import mesh

    gen = torch.Generator().manual_seed(100 + mesh.rank())
    shapes = payload["shapes"]
    grads = [torch.randn(s, generator=gen) * 10.0 ** torch.randint(-8, 3, s, generator=gen)
             for s in shapes]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    for i, (p, g) in enumerate(zip(params, grads)):
        if i != payload["no_grad"]:
            p.grad = g.clone()
    mesh.all_reduce_grads(params)
    return {"mine": [g.numpy().copy() for g in grads],
            "averaged": [None if p.grad is None else p.grad.numpy().copy() for p in params]}


def _recorded(trainer, events):
    """``trainer`` with its callbacks, log rows, eval batches, eval images
    and the checkpoints it wrote recorded by step in ``events``; returns
    the callback."""
    pipe = trainer._pipeline()
    eval_loss, eval_image, save = (pipe.get_eval_loss_dict,
                                   pipe.get_eval_image_metrics_and_images,
                                   trainer.save_checkpoint)

    def get_eval_loss_dict(step, generator):
        events["eval_batch"].append(step)
        return eval_loss(step, generator)

    def get_eval_image_metrics_and_images(idx):
        events["eval_image"].append(trainer.state.step)
        return eval_image(idx)

    def save_checkpoint(step):
        path = save(step)
        if path is not None:
            events["save"].append(step)
        return path

    pipe.get_eval_loss_dict = get_eval_loss_dict
    pipe.get_eval_image_metrics_and_images = get_eval_image_metrics_and_images
    trainer.save_checkpoint = save_checkpoint
    return lambda step, metrics: events["callback"].append(
        (step, {k: float(v) for k, v in metrics.items()}))


def dp_blocks(payload):
    """``Trainer`` with ``steps_per_dispatch`` of each of ``payload["blocks"]``
    on this rank (data-parallel under a group), the eager step (a dispatch
    of 1) updating through ``GroupedAdam.device_step`` as a block does: per
    run, the callbacks' steps and metrics, the log rows', eval batches',
    eval images' and checkpoints' steps, the final parameters and Adam
    moments, the step counts and ``steps_by_dispatch``."""
    from pathlib import Path

    from samnerf_tpu_torch.data.datamanager import DataManager
    from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from samnerf_tpu_torch.parallel import mesh

    runs = {}
    for block in payload["blocks"]:
        out = Path(payload["out"]) / f"block{block}_rank{mesh.rank()}"
        trainer = Trainer(payload["cfg"], TrainerConfig(
            output_dir=out, steps_per_dispatch=block, save_final=False,
            **payload["cadences"]), payload["groups"], DataManager(payload["dm"]),
            device="cpu")
        opt = trainer.optimizer
        if block == 1:
            def step(opt=opt):
                opt.device_step(torch.from_numpy(opt.block_scalars(1)[0]))
                opt.advance(1)

            opt.step = step
        events = {"callback": [], "eval_batch": [], "eval_image": [], "save": []}
        trainer.train(step_callback=_recorded(trainer, events))
        state = opt.state_dict()
        runs[block] = dict(
            events, log=[s for s, m in trainer.metrics_history if "total_loss" in m],
            params=_numpy(trainer.model.state_dict()),
            moments={n: (s["exp_avg"].numpy().copy(), s["exp_avg_sq"].numpy().copy())
                     for n, s in state["optimizer"]["state"].items()},
            count=state["count"], step=trainer.state.step,
            steps_since_update=trainer.state.steps_since_update,
            steps_by_dispatch=dict(trainer.steps_by_dispatch))
    return runs
