"""Pipeline: a DataManager and a model behind the reference's API.

Counterpart of ``samnerf_tpu/engine/pipeline.py`` (``VanillaPipeline``:
``get_train_loss_dict``, ``get_eval_loss_dict``,
``get_eval_image_metrics_and_images``, ``get_param_groups``).  The port's
model holds its parameters, so no method takes them.  Train batches are
drawn on the model's device (:func:`device_data.sample_batch`); eval
batches on the host from the DataManager's generator, as the JAX package
draws them.  Losses come back as tensors on the device; the image metrics
as Python numbers and the images as numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from samnerf_tpu_torch.core.cameras import generate_rays
from samnerf_tpu_torch.data.device_data import build_device_dataset, sample_batch
from samnerf_tpu_torch.engine.eval_render import ImageRenderer
from samnerf_tpu_torch.engine.optimizers import group_of
from samnerf_tpu_torch.models.sam_model import SAMModel, get_loss_dict
from samnerf_tpu_torch.utils.metrics import load_lpips_params, lpips, psnr, ssim


class VanillaPipeline:
    """Eval and loss functions over (model, datamanager).  ``device_data``
    is the training set on the device (built on first use when not
    given)."""

    def __init__(self, model: SAMModel, datamanager, get_features=(),
                 device_data: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.datamanager = datamanager
        self.get_features = tuple(get_features)
        self.device = next(model.parameters()).device
        self._cameras = datamanager.cameras.to(self.device)
        self._eval_cameras = datamanager.eval_cameras.to(self.device)
        self._device_data = device_data
        self.renderer = ImageRenderer(model)
        self._lpips = None      # loaded on first use; False when absent

    # --- train ------------------------------------------------------------
    @torch.no_grad()
    def get_train_loss_dict(self, step: int,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
        """The training losses of one batch drawn on the device (jitter
        and batch from ``generator``, else from a generator seeded with
        ``step``), without gradients."""
        dm = self.datamanager
        if self._device_data is None:
            self._device_data = build_device_dataset(dm, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(step)
        batch = sample_batch(generator, self._device_data,
                             dm.config.train_num_rays_per_batch, dm.config.patch_size,
                             (dm.cameras.height, dm.cameras.width))
        idx = batch["indices"]
        bundle = generate_rays(self._cameras, idx[:, 0], idx[:, 1:])
        outputs = self.model(bundle, get_features=self.get_features, train=True,
                             generator=generator)
        return get_loss_dict(self.model.config, outputs, batch)

    # --- eval batch -------------------------------------------------------
    def get_eval_loss_dict(self, step: int,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, torch.Tensor]:
        """The eval forward (``train=False``, no features) on a ray batch
        of the eval split: rgb targets only.  Without an eval split, the
        train losses."""
        dm = self.datamanager
        if dm.eval_images is None:
            return self.get_train_loss_dict(step, generator)
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in dm.next_eval(step).items()}
        idx = batch["indices"]
        bundle = generate_rays(self._eval_cameras, idx[:, 0], idx[:, 1:].float())
        outputs = self.model(bundle, train=False, get_features=())
        return get_loss_dict(self.model.config, outputs, batch)

    # --- eval image -------------------------------------------------------
    def get_eval_image_metrics_and_images(self, image_index: int = 0
                                          ) -> Tuple[Dict, Dict[str, np.ndarray]]:
        """Render one eval image: psnr, ssim, ``num_rays`` (and lpips when
        :func:`load_lpips_params` finds weights); images ``img`` (ground
        truth | prediction, side by side), ``depth``, ``accumulation``."""
        batch = self.datamanager.eval_image_batch(image_index)
        h, w = batch["image"].shape[:2]
        out = self.renderer.render_image_device(self._eval_cameras, image_index, w, h)
        gt = torch.as_tensor(batch["image"], device=self.device)
        pred = out["rgb"]
        metrics = {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt)),
                   "num_rays": h * w}
        if self._lpips is None:
            found = load_lpips_params(device=self.device)
            self._lpips = False if found is None else found
        if self._lpips is not False:
            metrics["lpips"] = float(lpips(pred, gt, self._lpips))
        images = {"img": np.concatenate([batch["image"], pred.cpu().numpy()], axis=1),
                  "depth": out["depth"].cpu().numpy(),
                  "accumulation": out["accumulation"].cpu().numpy()}
        return metrics, images

    # --- param groups -----------------------------------------------------
    def get_param_groups(self) -> Dict[str, list]:
        """Optimizer group -> its modules (``fields``,
        ``proposal_networks.i``, ``sam_field``, ``conv``), the JAX
        package's top-level keys in the port's names."""
        groups: Dict[str, list] = {}
        for name, _ in self.model.named_parameters():
            parts = name.split(".")
            module = ".".join(parts[:2]) if parts[0] == "proposal_networks" else parts[0]
            members = groups.setdefault(group_of(name), [])
            if module not in members:
                members.append(module)
        return groups
