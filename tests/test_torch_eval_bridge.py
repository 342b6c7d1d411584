"""A run trained by the JAX package, carried to the port on the CPU.

A tiny ``samnerf_distill``-shaped JAX ``Trainer`` (SAM and ClipSeg heads,
patch 2, four optimizer groups, ``conv`` clipped by global norm, so
``optax.multi_transform`` holds masked Adam states and a clip's empty
state) trains 3 steps and saves its orbax checkpoint beside the JAX
``config.json``.  The test restores it with the JAX trainer's template,
bridges it with ``convert.train_checkpoint_from_jax``, writes the port's
``samnerf_tpu_torch_ckpts/step-*.pt`` into the same run directory, and
rebuilds the port's trainer with ``eval_setup`` from the JAX config as it
is.  Held against the JAX package:

- parameters and Adam moments exactly (layout changes only), the step
  and update counts;
- the eval loss dict (rtol 1e-4, as the train-step test), the eval
  images' psnr and ssim (rtol 1e-4), ``compute_eval_metrics`` through
  ``scripts/eval.py`` (rtol 1e-4);
- one further train step from the bridged state on the same batch and
  jitter: losses rtol 1e-4, the updated parameters and first moments as
  ``tests/test_torch_train_step.py`` holds gradients (hash tables rtol
  1e-2 / atol 1e-4, the rest rtol 1e-3 / atol 1e-5).  The conv head's
  pre-activations keep more than 1e-6 from 0 (checked), as there.
"""
import dataclasses
import json

import numpy as np
import pytest
import jax
import torch

import samnerf_tpu.train as jax_train
from samnerf_tpu.configs.methods import method_configs as jax_methods
from samnerf_tpu.data.datamanager import (DataManager as JaxDataManager,
                                          DataManagerConfig as JaxDMConfig)
from samnerf_tpu.data.dataparser import DataparserConfig as JaxDPConfig
from samnerf_tpu.engine.optimizers import OptimizerGroupConfig as JaxGroup
from samnerf_tpu.engine.trainer import Trainer as JaxTrainer, TrainerConfig as JaxTC
from samnerf_tpu.utils.eval_utils import compute_eval_metrics as jax_eval_metrics
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.convert import params_from_jax, train_checkpoint_from_jax
from samnerf_tpu_torch.scripts import eval as eval_script
from samnerf_tpu_torch.utils import synthetic, writer
from samnerf_tpu_torch.utils.eval_utils import eval_setup, find_latest_checkpoint

from test_trainer import TINY_MODEL

STEPS = 3
GROUPS = {
    "proposal_networks": JaxGroup(lr=1e-2, lr_final=5e-4, max_steps=200),
    "fields": JaxGroup(lr=1e-2, lr_final=5e-4, max_steps=200),
    "sam_field": JaxGroup(lr=5e-3, lr_final=1e-4, max_steps=200),
    "conv": JaxGroup(lr=5e-3, lr_final=1e-4, max_steps=200, max_norm=1.0),
}
TABLE_TOL = dict(rtol=1e-2, atol=1e-4)
DENSE_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.write_scene(tmp_path_factory.mktemp("scene"), num_train=4,
                                 num_test=2, h=32, w=32, with_features=True,
                                 feature_long_side=8)


def _jax_config(scene, run_dir):
    config = jax_methods()["samnerf_distill"]
    config.model = TINY_MODEL
    config.datamanager = JaxDMConfig(
        dataparser=JaxDPConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=128, eval_num_rays_per_batch=128, patch_size=2,
        distill_sam=True, use_clipseg_feature=True)
    config.optimizers = GROUPS
    config.trainer = JaxTC(max_num_iterations=STEPS, steps_per_save=100000,
                           steps_per_eval_batch=0, steps_per_eval_image=0,
                           output_dir=run_dir, use_device_data=False, log_every=100)
    return config


def _snapshot(jtr):
    """The checkpoint dict as numpy: ``Trainer.load_checkpoint``'s template
    restore, then ``jax.device_get``."""
    return {"params": jax.device_get(jtr.state.params),
            "opt_state": jax.device_get(jtr.state.opt_state),
            "step": int(jtr.state.step),
            "steps_since_update": int(jtr.state.steps_since_update)}


@pytest.fixture(scope="module")
def jax_run(scene, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("jax_run")
    config = _jax_config(scene, run_dir)
    jax_train.save_config(config)
    dm = JaxDataManager(config.datamanager, seed=0)
    jtr = JaxTrainer(dataclasses.replace(config.model, num_images=dm.num_train_images),
                     config.trainer, config.optimizers, dm)
    jtr.train()
    path = sorted((run_dir / "samnerf_tpu_ckpts").glob("step-*"))[-1]
    jtr.load_checkpoint(path)
    ckpt = _snapshot(jtr)
    bridged = train_checkpoint_from_jax(ckpt)
    (run_dir / "samnerf_tpu_torch_ckpts").mkdir()
    torch.save(bridged, run_dir / "samnerf_tpu_torch_ckpts" / f"step-{STEPS:09d}.pt")
    return run_dir, jtr, path, ckpt


def test_bridge_carries_parameters_moments_and_counts(jax_run):
    run_dir, _, _, ckpt = jax_run
    bridged = torch.load(find_latest_checkpoint(run_dir / "samnerf_tpu_torch_ckpts"),
                         weights_only=True)
    assert set(bridged) == {"model", "optimizer", "step", "steps_since_update"}
    assert bridged["step"] == STEPS == bridged["optimizer"]["count"]
    assert bridged["steps_since_update"] == ckpt["steps_since_update"]
    inner = ckpt["opt_state"].inner_states
    assert set(inner) == set(GROUPS)
    conv_chain = inner["conv"].inner_state                 # (EmptyState, (adam, schedule))
    assert len(conv_chain) == 2 and conv_chain[0] == ()
    adam = conv_chain[1][0]
    kernel = adam.mu["params"]["conv"]["Conv_0"]["kernel"]
    state = bridged["optimizer"]["optimizer"]["state"]
    np.testing.assert_array_equal(state["conv.convs.0.weight"]["exp_avg"].numpy(),
                                  np.asarray(kernel).transpose(3, 2, 0, 1))
    fields = inner["fields"].inner_state[0][0]
    dense = fields.nu["params"]["fields"]["mlp_base"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        state["fields.mlp_base.layers.0.weight"]["exp_avg_sq"].numpy(),
        np.asarray(dense).T)
    assert set(state) == set(bridged["model"]) == set(params_from_jax(ckpt["params"]))
    assert all(s["step"].item() == STEPS for s in state.values())
    assert any(s["exp_avg"].abs().sum() > 0 for s in state.values())


def test_port_trainer_loads_the_jax_run(jax_run):
    run_dir, _, _, ckpt = jax_run
    raw = json.loads((run_dir / "config.json").read_text())       # the JAX file as it is
    assert {"steps_per_dispatch", "use_device_data"} <= set(raw["trainer"])
    assert {"sort_points", "use_remat"} <= set(raw["model"])
    tr, config = eval_setup(run_dir, device="cpu")
    assert config.method_name == "samnerf_distill"
    assert config.model.num_sam_samples == TINY_MODEL.num_sam_samples
    assert config.optimizers["conv"].max_norm == 1.0
    assert tr.state.step == STEPS and tr.optimizer.count == STEPS
    ref = params_from_jax(ckpt["params"])
    for name, value in tr.model.state_dict().items():
        torch.testing.assert_close(value, ref[name], rtol=0, atol=0, msg=name)


def test_eval_losses_and_metrics_match_jax(jax_run):
    run_dir, jtr, _, _ = jax_run
    tr, _ = eval_setup(run_dir, device="cpu")
    jpipe, pipe = jtr._pipeline(), tr._pipeline()
    jpipe.datamanager.rng = np.random.default_rng(3)
    pipe.datamanager.rng = np.random.default_rng(3)
    for step in (STEPS, STEPS + 1):
        ref = jpipe.get_eval_loss_dict(jtr.state.params, step, jax.random.PRNGKey(step))
        ours = pipe.get_eval_loss_dict(step)
        assert set(ours) == set(ref) == {"rgb_loss"}
        np.testing.assert_allclose(ours["rgb_loss"].item(), float(ref["rgb_loss"]), rtol=1e-4)
    for index in (0, 1):
        ref, _ = jpipe.get_eval_image_metrics_and_images(jtr.state.params, index)
        ours, _ = pipe.get_eval_image_metrics_and_images(index)
        for k in ("psnr", "ssim"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)


def test_eval_script_on_the_jax_run_and_on_a_port_run(jax_run, scene, tmp_path, capsys):
    run_dir, jtr, _, _ = jax_run
    if not torch.cuda.is_available():
        assert eval_script.main([str(run_dir)]) == 1          # the card is the default
    out = tmp_path / "eval.json"
    assert eval_script.main([str(run_dir), "--output", str(out)], device="cpu") == 0
    result = json.loads(out.read_text())
    assert result["experiment_name"] == "samnerf_distill"
    assert result["checkpoint_dir"] == str(run_dir / "samnerf_tpu_torch_ckpts")
    ref = jax_eval_metrics(jtr)
    assert result["results"]["num_images"] == ref["num_images"] == 2
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(result["results"][k], ref[k], rtol=1e-4, err_msg=k)

    # the port's own run directory, as the train entry writes it
    _, config = eval_setup(run_dir, device="cpu")
    config.trainer = dataclasses.replace(config.trainer, max_num_iterations=2,
                                         output_dir=tmp_path / "port_run")
    config.vis = "json"
    train_cli.save_config(config)
    trained = train_cli.train_loop(config, device="cpu")
    writer.reset()
    capsys.readouterr()
    assert eval_script.main([str(tmp_path / "port_run"), "--max-images", "1"],
                            device="cpu") == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["results"]["num_images"] == 1
    tr, _ = eval_setup(tmp_path / "port_run", device="cpu")
    for name, value in trained.model.state_dict().items():
        torch.testing.assert_close(tr.model.state_dict()[name], value, rtol=0, atol=0)


def test_one_train_step_after_the_bridge_matches_jax(jax_run):
    """The bridged Adam moments drive the next update as optax's do."""
    run_dir, jtr, path, _ = jax_run
    tr, _ = eval_setup(run_dir, device="cpu")
    rng = jax.random.PRNGKey(21)
    batch = jtr.datamanager.next_train(STEPS)
    levels = len(TINY_MODEL.num_proposal_samples_per_ray) + 1
    rays = batch["indices"].shape[0]
    jitter = [torch.from_numpy(np.array(jax.random.uniform(k, (rays, 1))))
              for k in jax.random.split(rng, levels)]
    margin = []
    tr.model.conv.convs[0].register_forward_hook(
        lambda m, i, o: margin.append(o.detach().abs().min().item()))
    ours = tr._train_step(tr.state, tr.cameras,
                          {k: torch.from_numpy(v) for k, v in batch.items()}, jitter=jitter)
    new_state, ref = jtr._train_step(jtr.state, jtr.cameras, batch, rng)
    try:
        assert margin[0] > 1e-6
        for k in ("rgb_loss", "interlevel_loss", "distortion_loss", "sam_loss",
                  "clipseg_loss", "total_loss"):
            np.testing.assert_allclose(ours[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
        params = params_from_jax(jax.device_get(new_state.params))
        moments = train_checkpoint_from_jax(
            {"params": jax.device_get(new_state.params),
             "opt_state": jax.device_get(new_state.opt_state),
             "step": STEPS + 1, "steps_since_update": 0})["optimizer"]
        assert moments["count"] == tr.optimizer.count == STEPS + 1
        state = tr.optimizer.state_dict()["optimizer"]["state"]
        for name, value in tr.model.state_dict().items():
            tol = TABLE_TOL if name.endswith("table") else DENSE_TOL
            np.testing.assert_allclose(value.numpy(), params[name].numpy(), err_msg=name, **tol)
            np.testing.assert_allclose(state[name]["exp_avg"].numpy(),
                                       moments["optimizer"]["state"][name]["exp_avg"].numpy(),
                                       err_msg=name, **tol)
    finally:
        jtr.state = new_state
        jtr.load_checkpoint(path)           # leave the JAX run at its checkpoint
