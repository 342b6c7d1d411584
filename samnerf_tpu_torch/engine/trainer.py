"""Trainer: the train step, the training loop and checkpoints.

Counterpart of ``samnerf_tpu/engine/trainer.py``.  As the JAX trainer
fuses ``steps_per_dispatch`` steps (default 20) into one ``lax.scan``
dispatch, the port runs them as one block: on the card, one replay of a
CUDA graph that holds the block's batch draws, forwards, backwards and
Adam updates (:mod:`samnerf_tpu_torch.engine.cuda_graph`; the first
block runs eagerly and is then captured), elsewhere the same steps
eagerly.  The per-step values a graph cannot hold as constants (the
proposal anneal and gate, Adam's step sizes) come from a device buffer
that the host fills for the whole block (:func:`dispatch_scalars`).
The loop keeps the JAX trainer's semantics: metrics are the block's last
step's, and logs, evals, callbacks, step times and saves come once per
block, where ``_crossed`` says a cadence was passed; the steps that do
not fill a last block run one at a time.  ``steps_per_dispatch=1`` is
the eager step, one launch per op, with ``torch.optim.Adam``.
The whole training set lives on the card and each batch is sampled there
(:mod:`samnerf_tpu_torch.data.device_data`).  The in-training eval
cadence runs through :class:`samnerf_tpu_torch.engine.pipeline.VanillaPipeline`
(an eval-batch loss every ``steps_per_eval_batch`` steps, an eval image
with PSNR / SSIM every ``steps_per_eval_image``), and every step's times
and, at the ``log_every`` cadence, its losses go to the event writers of
:mod:`samnerf_tpu_torch.utils.writer`.  The host reads a device value
only when a cadence fires.  Each step runs under ``train_lock``, which a
viewer attached to the run takes for each frame, so a frame lands between
blocks and never reads the parameters in the middle of an update.

Data parallelism (the JAX trainer's mesh) runs over the process group of
:mod:`samnerf_tpu_torch.parallel.mesh`, one process per card: every rank
draws the same global batch and stratification jitter from identically
seeded generators and keeps its contiguous share (whole patches), takes
the mean loss of its share (a masked feature loss divided by the group's
count of valid targets over the world size), and averages the gradients
over the group before the optimizer step, so the step is the unsharded
step.  Only the main process evaluates
(from a generator of its own, so the ranks' batch draws stay in step) and
writes checkpoints.  The data-parallel step stays eager, one step a
block: its per-tensor gradient all-reduce would have to be captured by
every rank in lockstep, and a bucketed all-reduce that a graph could hold
is queued (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.data.device_data import build_device_dataset, sample_batch
from samnerf_tpu_torch.engine import cuda_graph
from samnerf_tpu_torch.engine.optimizers import (GroupedAdam, OptimizerGroupConfig,
                                                 build_optimizer)
from samnerf_tpu_torch.engine.pipeline import VanillaPipeline
from samnerf_tpu_torch.models.sam_model import (SAMModel, SAMModelConfig,
                                                get_loss_dict, init_params,
                                                proposal_anneal_value,
                                                proposal_grad_gate)
from samnerf_tpu_torch.parallel import mesh as mesh_lib
from samnerf_tpu_torch.utils import writer


CKPT_DIR = "samnerf_tpu_torch_ckpts"
"""The checkpoints' directory under a run's output directory."""


@dataclasses.dataclass
class TrainState:
    step: int = 0
    steps_since_update: int = 0


@dataclasses.dataclass
class TrainerConfig:
    max_num_iterations: int = 10000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 10000000
    save_only_latest_checkpoint: bool = True
    output_dir: Path = Path("outputs")
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    log_every: int = 100
    seed: int = 42
    steps_per_dispatch: int = 20
    """Training steps per dispatch: on the card one CUDA graph replay runs
    them; metrics come from the block's last step.  1: the eager step."""
    save_final: bool = True


def loss_and_grads(model: SAMModel, cfg: SAMModelConfig, state: Optional[TrainState],
                   cameras: Cameras, batch: Dict[str, torch.Tensor],
                   get_features: Tuple[str, ...],
                   generator: Optional[torch.Generator] = None,
                   jitter: Optional[Sequence[torch.Tensor]] = None,
                   distributed: bool = False,
                   scalars: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Forward and backward of one step: leaves the gradients in ``.grad``
    and returns (loss dict, total loss, proposal gate).  ``distributed``:
    ``batch`` is this rank's share, and each masked feature loss divides
    by the group's count of valid targets over the world size.
    ``scalars``: the step's anneal and gate as 0-d tensors (a row of
    :func:`dispatch_scalars` on the device) in place of their values at
    ``state``."""
    if scalars is None:
        anneal = proposal_anneal_value(cfg, state.step)
        gate = proposal_grad_gate(cfg, state.step, state.steps_since_update)
    else:
        anneal, gate = scalars
    indices = batch["indices"]
    ray_bundle = generate_rays(cameras, indices[:, 0], indices[:, 1:])
    outputs = model(ray_bundle, get_features=get_features, train=True,
                    jitter=jitter, generator=generator, anneal=anneal,
                    proposal_grad=gate)
    denoms = feature_denominators(batch) if distributed else None
    loss_dict = get_loss_dict(cfg, outputs, batch, denoms)
    total = sum(loss_dict.values())
    total.backward()
    return loss_dict, total, gate


def feature_denominators(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """For each feature target of this rank's batch share: the group's
    count of finite (valid) targets, floored at 1, over the world size, so
    that the ranks' mean of a masked loss is the global batch's."""
    names = [k for k in ("sam", "dino", "clipseg") if k in batch]
    if not names:
        return {}
    counts = torch.stack([torch.isfinite(batch[k]).all(dim=-1).sum().float()
                          for k in names])
    total = mesh_lib.all_reduce_sum(counts)
    return dict(zip(names, torch.clamp_min(total, 1.0) / mesh_lib.world_size()))


def make_train_step(model: SAMModel, cfg: SAMModelConfig, optimizer: GroupedAdam,
                    get_features: Tuple[str, ...], distributed: bool = False) -> Callable:
    """(state, cameras, batch, generator) -> metrics; updates the model's
    parameters, the optimizer and ``state`` in place.  Metrics stay on
    the device until the caller reads them.  ``distributed``: the batch is
    this rank's share; gradients and metrics are averaged over the process
    group before the update."""

    def train_step(state: TrainState, cameras: Cameras,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   jitter: Optional[Sequence[torch.Tensor]] = None):
        optimizer.zero_grad()
        loss_dict, total, gate = loss_and_grads(model, cfg, state, cameras, batch,
                                                get_features, generator, jitter,
                                                distributed)
        if distributed:
            mesh_lib.all_reduce_grads(model.parameters())
        optimizer.step()
        state.step += 1
        state.steps_since_update = 0 if gate > 0 else state.steps_since_update + 1
        metrics = step_metrics(loss_dict, total)
        if distributed:
            names = sorted(metrics)
            mean = (mesh_lib.all_reduce_sum(torch.stack([metrics[k] for k in names]))
                    / mesh_lib.world_size())
            metrics = dict(zip(names, mean))
        return add_psnr(metrics)

    return train_step


def step_metrics(loss_dict: Dict[str, torch.Tensor],
                 total: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The step's losses and their total, detached, on the device."""
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["total_loss"] = total.detach()
    return metrics


def add_psnr(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``metrics`` with the rgb loss's PSNR."""
    metrics["psnr"] = -10.0 * torch.log10(torch.clamp_min(metrics["rgb_loss"], 1e-10))
    return metrics


def dispatch_scalars(cfg: SAMModelConfig, optimizer: GroupedAdam, step: int,
                     steps_since_update: int, n: int):
    """The per-step values of the ``n`` steps from ``step``, as
    ``make_train_step`` computes them one step at a time: [n, 2 + 2G] f32
    rows of the proposal anneal and gate (``steps_since_update`` evolved
    through the block as the step evolves it) and each optimizer group's
    two Adam scalars (:meth:`GroupedAdam.block_scalars`); also
    ``steps_since_update`` after the block."""
    rows = np.empty((n, 2 + 2 * len(optimizer.names)), np.float32)
    since = steps_since_update
    for i in range(n):
        gate = proposal_grad_gate(cfg, step + i, since)
        rows[i, :2] = proposal_anneal_value(cfg, step + i), gate
        since = 0 if gate > 0 else since + 1
    rows[:, 2:] = optimizer.block_scalars(n).reshape(n, -1)
    return rows, since


def shard_step_inputs(model: SAMModel, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator, rank: int, world: int):
    """This rank's share of a global batch and of the stratification
    jitter drawn for it at the global shape, as (batch, jitter).  Raises
    ValueError when ``world`` does not divide the rays or the patches."""
    num_rays = batch["indices"].shape[0]
    jitter = model.draw_jitter(num_rays, generator, batch["indices"].device)
    return ({k: mesh_lib.shard(v, rank, world) for k, v in batch.items()},
            tuple(mesh_lib.shard(j, rank, world) for j in jitter))


class Trainer:
    """The training loop on one device (``cuda`` unless ``device`` says
    otherwise); with a process group up, data-parallel over its ranks,
    one eager step a block."""

    def __init__(self, model_cfg: SAMModelConfig, trainer_cfg: TrainerConfig,
                 optimizer_groups: Dict[str, OptimizerGroupConfig], datamanager,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.datamanager = datamanager
        self.device = torch.device(device)
        self.model = SAMModel(model_cfg, device=self.device)
        self.model.load_state_dict(init_params(
            model_cfg, torch.Generator().manual_seed(trainer_cfg.seed), self.device))
        self.get_features = tuple(
            f for f, on in (("sam", True), ("dino", model_cfg.use_dino_feature),
                            ("clipseg", model_cfg.use_clipseg_feature))
            if on and model_cfg.distill_sam)
        self.distributed = mesh_lib.is_initialized()
        self.rank, self.world = mesh_lib.rank(), mesh_lib.world_size()
        if self.distributed:
            dm_cfg = datamanager.config
            patches = dm_cfg.train_num_rays_per_batch // max(dm_cfg.patch_size, 1) ** 2
            if dm_cfg.train_num_rays_per_batch % self.world or patches % self.world:
                raise ValueError(f"{dm_cfg.train_num_rays_per_batch} rays per batch "
                                 f"({patches} patches) do not split over {self.world} ranks")
            for t in self.model.state_dict().values():
                torch.distributed.broadcast(t, 0)
        self.optimizer = build_optimizer(optimizer_groups, self.model)
        self.state = TrainState()
        self.cameras = datamanager.cameras.to(self.device)
        self.device_data = build_device_dataset(datamanager, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            trainer_cfg.seed + 1)
        # only the main process evaluates; under data parallelism from a
        # generator of its own, so the ranks' batch draws stay in step
        self.eval_generator = (torch.Generator(device=self.device).manual_seed(
            trainer_cfg.seed + 2) if self.distributed else self.generator)
        self._train_step = make_train_step(self.model, model_cfg, self.optimizer,
                                           self.get_features, self.distributed)
        if trainer_cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{trainer_cfg.steps_per_dispatch}")
        # blocks of steps_per_dispatch steps (module docstring), else the eager step
        self.block = 1 if self.distributed else trainer_cfg.steps_per_dispatch
        self._graph: Optional[cuda_graph.CapturedGraph] = None
        self._graph_key = None
        self._scalars: Optional[torch.Tensor] = None    # the graph's [block, C] input
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        and self.block > 1 else None)
        # steps run eagerly, captured into the block's graph (not run) and
        # run by its replays, for the caller's bookkeeping
        self.steps_by_dispatch = {"eager": 0, "captured": 0, "replayed": 0}
        self.metrics_history = []
        self._pipeline_obj = None
        self.train_lock = threading.Lock()
        if trainer_cfg.load_dir is not None:
            ckpts = sorted(Path(trainer_cfg.load_dir).glob("step-*.pt"))
            if not ckpts:
                raise FileNotFoundError(f"no checkpoints under {trainer_cfg.load_dir}")
            path = (Path(trainer_cfg.load_dir) / f"step-{trainer_cfg.load_step:09d}.pt"
                    if trainer_cfg.load_step is not None else ckpts[-1])
            self.load_checkpoint(path)
            print(f"resumed from {path} at step {self.state.step}", flush=True)

    def _sample_batch(self) -> Dict[str, torch.Tensor]:
        dm = self.datamanager
        return sample_batch(self.generator, self.device_data,
                            dm.config.train_num_rays_per_batch, dm.config.patch_size,
                            (dm.cameras.height, dm.cameras.width))

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        """One training step from the current state (``step`` is its
        index, for the caller's bookkeeping): the eager step, or with
        blocks a block of one step."""
        if self.block > 1:
            return self.run_block(1)
        self.steps_by_dispatch["eager"] += 1
        batch = self._sample_batch()
        if self.distributed:
            batch, jitter = shard_step_inputs(self.model, batch, self.generator,
                                              self.rank, self.world)
            return self._train_step(self.state, self.cameras, batch, jitter=jitter)
        return self._train_step(self.state, self.cameras, batch, self.generator)

    def _block_step(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step of a block from ``row`` (a row of :func:`dispatch_scalars`
        on the device): no host sync and no host state changed, so a graph
        can hold it."""
        batch = self._sample_batch()
        self.optimizer.zero_grad()
        loss_dict, total, _ = loss_and_grads(
            self.model, self.model_cfg, None, self.cameras, batch, self.get_features,
            self.generator, scalars=(row[0], row[1]))
        self.optimizer.device_step(row[2:].reshape(len(self.optimizer.names), 2))
        return add_psnr(step_metrics(loss_dict, total))

    def _block(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        metrics = None
        for i in range(rows.shape[0]):
            metrics = self._block_step(rows[i])
        return metrics

    def run_block(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` steps from the current state; returns the last step's
        metrics.  On the card a block of ``steps_per_dispatch`` steps is
        one replay of the block's graph (the first such block runs eagerly,
        then is captured); other blocks, and every block elsewhere, run
        the same steps eagerly.  The host advances the state and the
        optimizer's counts once the steps have run."""
        rows, since = dispatch_scalars(self.model_cfg, self.optimizer,
                                          self.state.step, self.state.steps_since_update, n)
        if self._stream is None:
            metrics = self._block(torch.from_numpy(rows).to(self.device))
            self.steps_by_dispatch["eager"] += n
        else:
            metrics = self._run_block_on_card(rows)
        self.state.step += n
        self.state.steps_since_update = since
        self.optimizer.advance(n)
        return metrics

    def _run_block_on_card(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            n = rows.shape[0]
            if n != self.block:
                metrics = self._block(torch.from_numpy(rows).to(self.device))
                self.steps_by_dispatch["eager"] += n
            else:
                if self._scalars is None:
                    self._scalars = torch.empty(rows.shape, device=self.device)
                self._scalars.copy_(torch.from_numpy(rows))
                if self._graph is not None and self._tensors_key() == self._graph_key:
                    metrics = self._graph.replay()
                    self.steps_by_dispatch["replayed"] += n
                else:
                    metrics = self._block(self._scalars)      # makes the moments, once
                    self._graph = cuda_graph.capture(lambda: self._block(self._scalars),
                                                     stream, (self.generator,))
                    self._graph_key = self._tensors_key()
                    self.steps_by_dispatch["eager"] += n
                    self.steps_by_dispatch["captured"] += n
            metrics = {k: v.clone() for k, v in metrics.items()}
        current.wait_stream(stream)
        for v in metrics.values():
            v.record_stream(current)
        return metrics

    def _tensors_key(self) -> tuple:
        """The addresses of the parameters and Adam moments a graph updates:
        a loaded optimizer state has new ones, and the block is captured
        anew."""
        state = self.optimizer.optimizer.state
        return tuple(t.data_ptr() for p in self.model.parameters()
                     for t in (p, *(v for k, v in state.get(p, {}).items() if k != "step")))

    @staticmethod
    def _crossed(step: int, n: int, every: int) -> bool:
        """Did [step - n, step) cross a multiple of ``every``?  (A block
        advances ``n`` steps at a time, so ``step % every == 0`` would
        skip.)"""
        return every > 0 and (step // every) != ((step - n) // every)

    def _pipeline(self):
        """The eval pipeline, built on first use over the trainer's model
        and training set on the device."""
        if self._pipeline_obj is None:
            self._pipeline_obj = VanillaPipeline(self.model, self.datamanager,
                                                 self.get_features, self.device_data)
        return self._pipeline_obj

    def eval_iteration(self, step: int, n: int = 1):
        """The in-training eval: the eval-batch losses every
        ``steps_per_eval_batch`` steps, a whole eval image with PSNR / SSIM
        every ``steps_per_eval_image``; both go to the event writers."""
        if self.datamanager.eval_images is None:
            return
        if self._crossed(step, n, self.cfg.steps_per_eval_batch):
            losses = self._pipeline().get_eval_loss_dict(step, self.eval_generator)
            losses = {k: float(v) for k, v in losses.items()}
            writer.put_scalar("Eval Loss", sum(losses.values()), step)
            writer.put_dict("Eval Loss Dict", losses, step)
        if self._crossed(step, n, self.cfg.steps_per_eval_image):
            n_eval = self.datamanager.eval_images.shape[0]
            idx = (step // self.cfg.steps_per_eval_image) % max(n_eval, 1)
            t0 = time.time()
            metrics, images = self._pipeline().get_eval_image_metrics_and_images(idx)
            dt = max(time.time() - t0, 1e-9)
            writer.put_scalar(writer.EventName.CURR_TEST_PSNR, metrics["psnr"], step)
            writer.put_time(writer.EventName.TEST_RAYS_PER_SEC, metrics["num_rays"] / dt,
                            step, avg_over_steps=False)
            writer.put_dict("Eval Images Metrics", metrics, step)
            for name, img in images.items():
                writer.put_image(f"Eval Images/{name}", img, step)
            self.metrics_history.append((step, dict(metrics)))

    def train(self, step_callback: Optional[Callable[[int, Dict], None]] = None):
        """The loop of the JAX trainer: blocks of ``steps_per_dispatch``
        steps while a whole block fits, then single steps.  The cadences
        see the steps a dispatch ran, where JAX hands its single steps the
        count that remains (``min(block, remaining)``) and so fires a
        cadence again for a multiple the block before passed, and every
        cadence at the first step of a run shorter than a block."""
        num_rays = self.datamanager.config.train_num_rays_per_batch
        step = self.state.step
        every = self.cfg.steps_per_save
        next_save = (step // every + 1) * every
        last_saved = None
        # rays/s counts from the end of the first block, so start-up is not in it
        warm_step = warm_t = None
        t_prev = time.time()
        while step < self.cfg.max_num_iterations:
            n = min(self.block, self.cfg.max_num_iterations - step)
            with self.train_lock:
                if n == self.block > 1:
                    metrics = self.run_block(n)
                else:
                    metrics = self.train_iteration(step)
                    n = 1
            step += n
            if warm_step is None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                warm_step, warm_t = step, time.time()
            now = time.time()
            writer.put_time(writer.EventName.ITER_TRAIN_TIME, (now - t_prev) / n, step)
            if step > warm_step:
                writer.put_time(writer.EventName.RAYS_PER_SEC,
                                num_rays * (step - warm_step) / max(now - warm_t, 1e-9), step)
            t_prev = now
            if self._crossed(step, n, max(self.cfg.log_every, 1)) or \
                    step >= self.cfg.max_num_iterations:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (f"rays/s={num_rays * (step - warm_step) / max(time.time() - warm_t, 1e-9):,.0f}"
                        if step > warm_step else "rays/s=warmup")
                print(f"step {step}: loss={m['total_loss']:.5f} "
                      f"psnr={m['psnr']:.2f} {rate}", flush=True)
                writer.put_dict("Train Loss Dict", m, step)
                self.metrics_history.append((step, m))
            if mesh_lib.is_main_process():
                self.eval_iteration(step, n)
            writer.write_out_storage()
            if step_callback is not None:
                step_callback(step, metrics)
            if step >= next_save:
                self.save_checkpoint(step)
                last_saved = step
                next_save += every
        if last_saved != step and self.cfg.save_final:
            self.save_checkpoint(step)
        writer.finalize()
        return self.state

    # --- checkpoints: model state, optimizer state, loop step -----------
    def _ckpt_dir(self) -> Path:
        d = Path(self.cfg.output_dir) / CKPT_DIR
        d.mkdir(parents=True, exist_ok=True)
        return d

    def save_checkpoint(self, step: int) -> Optional[Path]:
        """Written by the main process only (None elsewhere)."""
        if not mesh_lib.is_main_process():
            return None
        path = self._ckpt_dir() / f"step-{step:09d}.pt"
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": int(step),
                    "steps_since_update": self.state.steps_since_update}, path)
        if self.cfg.save_only_latest_checkpoint:
            for old in sorted(self._ckpt_dir().glob("step-*.pt"))[:-1]:
                old.unlink()
        return path

    def load_checkpoint(self, path: Path) -> None:
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.state = TrainState(step=ckpt["step"],
                                steps_since_update=ckpt["steps_since_update"])
