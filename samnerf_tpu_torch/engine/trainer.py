"""Trainer: the train step, the training loop and checkpoints.

Counterpart of ``samnerf_tpu/engine/trainer.py`` on one card.  What the
JAX trainer does only to schedule the TPU is left out: there is no mesh
(one card needs none), and a Python loop over steps takes the place of
the ``lax.scan`` that fuses ``steps_per_dispatch`` steps into one
dispatch (CUDA graphs would be its counterpart, in a later change).  The
whole training set lives on the card and each batch is sampled there
(:mod:`samnerf_tpu_torch.data.device_data`).  The in-training eval
cadence runs through :class:`samnerf_tpu_torch.engine.pipeline.VanillaPipeline`
(an eval-batch loss every ``steps_per_eval_batch`` steps, an eval image
with PSNR / SSIM every ``steps_per_eval_image``), and every step's times
and, at the ``log_every`` cadence, its losses go to the event writers of
:mod:`samnerf_tpu_torch.utils.writer`.  The host reads a device value
only when a cadence fires.  Each step runs under ``train_lock``, which a
viewer attached to the run takes for each frame, so a frame never reads
the parameters in the middle of an optimizer update.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.data.device_data import build_device_dataset, sample_batch
from samnerf_tpu_torch.engine.optimizers import (GroupedAdam, OptimizerGroupConfig,
                                                 build_optimizer)
from samnerf_tpu_torch.engine.pipeline import VanillaPipeline
from samnerf_tpu_torch.models.sam_model import (SAMModel, SAMModelConfig,
                                                get_loss_dict, init_params,
                                                proposal_anneal_value,
                                                proposal_grad_gate)
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
    save_final: bool = True


def loss_and_grads(model: SAMModel, cfg: SAMModelConfig, state: TrainState,
                   cameras: Cameras, batch: Dict[str, torch.Tensor],
                   get_features: Tuple[str, ...],
                   generator: Optional[torch.Generator] = None,
                   jitter: Optional[Sequence[torch.Tensor]] = None):
    """Forward and backward of one step: leaves the gradients in ``.grad``
    and returns (loss dict, total loss, proposal gate)."""
    anneal = proposal_anneal_value(cfg, state.step)
    gate = proposal_grad_gate(cfg, state.step, state.steps_since_update)
    indices = batch["indices"]
    ray_bundle = generate_rays(cameras, indices[:, 0], indices[:, 1:])
    outputs = model(ray_bundle, get_features=get_features, train=True,
                    jitter=jitter, generator=generator, anneal=anneal,
                    proposal_grad=gate)
    loss_dict = get_loss_dict(cfg, outputs, batch)
    total = sum(loss_dict.values())
    total.backward()
    return loss_dict, total, gate


def make_train_step(model: SAMModel, cfg: SAMModelConfig, optimizer: GroupedAdam,
                    get_features: Tuple[str, ...]) -> Callable:
    """(state, cameras, batch, generator) -> metrics; updates the model's
    parameters, the optimizer and ``state`` in place.  Metrics stay on
    the device until the caller reads them."""

    def train_step(state: TrainState, cameras: Cameras,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   jitter: Optional[Sequence[torch.Tensor]] = None):
        optimizer.zero_grad()
        loss_dict, total, gate = loss_and_grads(model, cfg, state, cameras, batch,
                                                get_features, generator, jitter)
        optimizer.step()
        state.step += 1
        state.steps_since_update = 0 if gate > 0 else state.steps_since_update + 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["total_loss"] = total.detach()
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp_min(metrics["rgb_loss"], 1e-10))
        return metrics

    return train_step


class Trainer:
    """The training loop on one device (``cuda`` unless ``device`` says
    otherwise)."""

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
        self.optimizer = build_optimizer(optimizer_groups, self.model)
        self.state = TrainState()
        self.cameras = datamanager.cameras.to(self.device)
        self.device_data = build_device_dataset(datamanager, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            trainer_cfg.seed + 1)
        self._train_step = make_train_step(self.model, model_cfg, self.optimizer,
                                           self.get_features)
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

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        dm = self.datamanager
        batch = sample_batch(self.generator, self.device_data,
                             dm.config.train_num_rays_per_batch, dm.config.patch_size,
                             (dm.cameras.height, dm.cameras.width))
        return self._train_step(self.state, self.cameras, batch, self.generator)

    @staticmethod
    def _crossed(step: int, n: int, every: int) -> bool:
        """Did the steps [step - n, step) cross a multiple of ``every``?
        (The port advances one step at a time: ``n`` = 1.)"""
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
            losses = self._pipeline().get_eval_loss_dict(step, self.generator)
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
        num_rays = self.datamanager.config.train_num_rays_per_batch
        step = self.state.step
        every = self.cfg.steps_per_save
        next_save = (step // every + 1) * every
        last_saved = None
        # rays/s counts from the end of the first step, so start-up is not in it
        warm_step = warm_t = None
        t_prev = time.time()
        while step < self.cfg.max_num_iterations:
            with self.train_lock:
                metrics = self.train_iteration(step)
            step += 1
            if warm_step is None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                warm_step, warm_t = step, time.time()
            now = time.time()
            writer.put_time(writer.EventName.ITER_TRAIN_TIME, now - t_prev, step)
            if step > warm_step:
                writer.put_time(writer.EventName.RAYS_PER_SEC,
                                num_rays * (step - warm_step) / max(now - warm_t, 1e-9), step)
            t_prev = now
            if self._crossed(step, 1, max(self.cfg.log_every, 1)) or \
                    step >= self.cfg.max_num_iterations:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (f"rays/s={num_rays * (step - warm_step) / max(time.time() - warm_t, 1e-9):,.0f}"
                        if step > warm_step else "rays/s=warmup")
                print(f"step {step}: loss={m['total_loss']:.5f} "
                      f"psnr={m['psnr']:.2f} {rate}", flush=True)
                writer.put_dict("Train Loss Dict", m, step)
                self.metrics_history.append((step, m))
            self.eval_iteration(step)
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

    def save_checkpoint(self, step: int) -> Path:
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
