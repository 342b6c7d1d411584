"""Evaluation of a run directory: its config, its latest checkpoint, and
PSNR / SSIM over the eval split.

Counterpart of ``samnerf_tpu/utils/eval_utils.py``.  A run directory
holds ``config.json`` and ``samnerf_tpu_torch_ckpts/step-*.pt``, as
``samnerf_tpu_torch.train`` writes them.  The config may also be one the
JAX package wrote (keys the port's dataclasses lack, such as
``use_device_data``, ``sort_points`` or ``use_remat``, are ignored;
``steps_per_dispatch`` is restored), with a checkpoint bridged by
:func:`samnerf_tpu_torch.convert.train_checkpoint_from_jax`.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.data.datamanager import DataManager
from samnerf_tpu_torch.engine.eval_render import ImageRenderer
from samnerf_tpu_torch.engine.trainer import CKPT_DIR, Trainer
from samnerf_tpu_torch.utils.metrics import psnr, ssim


def find_latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    """The highest ``step-*.pt`` under ``ckpt_dir``, or None."""
    ckpts = sorted(Path(ckpt_dir).glob("step-*.pt"))
    return ckpts[-1] if ckpts else None


def _restore_json(obj, raw):
    """Recursively overlay a saved ``config.json`` subtree onto a config
    dataclass, coercing JSON values back to the field's current type.
    Fields whose current value is not JSON-representable (dtypes,
    callables) keep the preset default.  Returns the (possibly new)
    object so frozen dataclasses work too."""
    if dataclasses.is_dataclass(obj) and isinstance(raw, dict):
        updates = {}
        for f in dataclasses.fields(obj):
            if f.name not in raw:
                continue
            updates[f.name] = _restore_json(getattr(obj, f.name), raw[f.name])
        return dataclasses.replace(obj, **updates) if updates else obj
    cur = obj
    if isinstance(cur, Path):
        return Path(raw)
    if isinstance(cur, tuple):
        if raw is None:
            return cur
        # template each raw element on its positional counterpart (extra
        # elements fall back to the last template) so heterogeneous
        # tuples, such as dicts with differing key sets, restore per slot
        return tuple(
            _restore_json(cur[min(i, len(cur) - 1)], v) if cur else v
            for i, v in enumerate(raw))
    if isinstance(cur, dict):
        if not isinstance(raw, dict):
            return cur
        out = dict(cur)   # keep default keys absent from the saved file
        for k, v in raw.items():
            out[k] = _restore_json(cur[k], v) if k in cur else v
        return out
    if cur is None or isinstance(cur, (bool, int, float, str)):
        return raw
    return cur   # non-JSON leaf (dtype, callable): keep the default


def eval_setup(run_dir: Path, device="cuda"):
    """(trainer, config) rebuilt from a run directory on ``device``: the
    whole saved config over the method preset, the latest checkpoint
    loaded.  ``compute_dtype`` is read from its saved name (either
    package's), which ``_restore_json`` would leave at the default."""
    run_dir = Path(run_dir)
    raw = json.loads((run_dir / "config.json").read_text())
    config = _restore_json(method_configs()[raw["method_name"]], raw)
    if "bfloat16" in str(raw.get("model", {}).get("compute_dtype", "")):
        config.model = dataclasses.replace(config.model, compute_dtype="bfloat16")
    config.trainer.output_dir = run_dir
    dm = DataManager(config.datamanager, seed=config.trainer.seed)
    config.model = dataclasses.replace(config.model, num_images=dm.num_train_images)
    trainer = Trainer(config.model, config.trainer, config.optimizers, dm, device=device)
    ckpt = find_latest_checkpoint(run_dir / CKPT_DIR)
    if ckpt is not None:
        trainer.load_checkpoint(ckpt)
    return trainer, config


def compute_eval_metrics(trainer, max_images: Optional[int] = None) -> dict:
    """Mean PSNR / SSIM over the first ``max_images`` eval images."""
    renderer = ImageRenderer(trainer.model)
    dm = trainer.datamanager
    cams = dm.eval_cameras.to(trainer.device)
    n = dm.eval_images.shape[0]
    if max_images is not None:
        n = min(n, max_images)
    psnrs, ssims = [], []
    for i in range(n):
        rgb = renderer.render_image_device(cams, i, cams.width, cams.height,
                                           minimal=True)["rgb"]
        gt = torch.as_tensor(dm.eval_images[i], device=trainer.device).float() / 255.0
        psnrs.append(float(psnr(rgb, gt)))
        ssims.append(float(ssim(rgb, gt)))
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "num_images": n}
