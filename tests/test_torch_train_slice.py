"""The port's training slice on the CPU: the ``Trainer`` on a small
synthetic scene, its checkpoints, the ``samnerf_tpu_torch.train`` CLI and
the data path (the scene's arrays and the batches drawn on the device,
against the JAX package's)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from samnerf_tpu.data import device_data as jax_device_data
from samnerf_tpu.data.datamanager import (DataManager as JaxDataManager,
                                          DataManagerConfig as JaxDMConfig)
from samnerf_tpu.data.dataparser import DataparserConfig as JaxDPConfig
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.data.device_data import (build_device_dataset, gather_batch,
                                                indices_from_uniform, patch_centers,
                                                sample_batch, uniform_shape)
from samnerf_tpu_torch.engine.optimizers import OptimizerGroupConfig
from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
from samnerf_tpu_torch.models.sam_model import SAMModelConfig
from samnerf_tpu_torch.utils import synthetic

TINY = SAMModelConfig(
    num_levels=4, max_res=128, log2_hashmap_size=12,
    num_proposal_samples_per_ray=(12,), num_nerf_samples_per_ray=12,
    proposal_net_args=({"hidden_dim": 8, "log2_hashmap_size": 10,
                        "num_levels": 3, "max_res": 64},),
    hashgrid_layers=(2, 2), hashgrid_resolutions=((16, 32), (32, 64)),
    hashgrid_sizes=(9, 9), num_sam_samples=4, patch_size=2, far_plane=6.0,
    hash_fn="morton")
GROUPS = {
    "proposal_networks": OptimizerGroupConfig(lr=1e-2, lr_final=5e-4, max_steps=200),
    "fields": OptimizerGroupConfig(lr=1e-2, lr_final=5e-4, max_steps=200),
    "sam_field": OptimizerGroupConfig(lr=5e-3, lr_final=1e-4, max_steps=200),
    "conv": OptimizerGroupConfig(lr=5e-3, lr_final=1e-4, max_steps=200),
}
STEPS = 40


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.write_scene(tmp_path_factory.mktemp("scene"), num_train=6,
                                 num_test=2, h=32, w=32, with_features=True,
                                 feature_long_side=8)


def _dm_config(scene):
    return DataManagerConfig(
        dataparser=DataparserConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=256, patch_size=2, distill_sam=True,
        use_clipseg_feature=True)


def _trainer_config(out, **kw):
    return TrainerConfig(max_num_iterations=STEPS, steps_per_save=100000, log_every=10,
                         steps_per_eval_batch=0, steps_per_eval_image=0,
                         output_dir=out, **kw)


@pytest.fixture(scope="module")
def trained(scene, tmp_path_factory):
    # one callback a step: the eager step (blocks: tests/test_torch_dispatch.py)
    tr = Trainer(TINY, _trainer_config(tmp_path_factory.mktemp("out"), steps_per_dispatch=1),
                 GROUPS, DataManager(_dm_config(scene)), device="cpu")
    losses = []
    tr.train(step_callback=lambda step, m: losses.append(
        {k: float(v) for k, v in m.items()}))
    return tr, losses


def test_trainer_lowers_rgb_loss(trained):
    tr, losses = trained
    assert len(losses) == STEPS and tr.state.step == STEPS
    assert all(np.isfinite(list(m.values())).all() for m in losses)
    rgb = [m["rgb_loss"] for m in losses]
    assert np.mean(rgb[-5:]) < 0.5 * np.mean(rgb[:5]), rgb
    assert {"interlevel_loss", "distortion_loss", "sam_loss", "clipseg_loss"} <= set(losses[0])
    assert [s for s, _ in tr.metrics_history] == [10, 20, 30, 40]


def test_checkpoint_round_trips_and_resumes(trained):
    tr, _ = trained
    ckpts = sorted(tr._ckpt_dir().glob("step-*.pt"))
    assert [p.name for p in ckpts] == [f"step-{STEPS:09d}.pt"]     # the final save
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = tr.optimizer.state_dict()
    with torch.no_grad():
        for p in tr.model.parameters():
            p.zero_()
    tr.load_checkpoint(ckpts[-1])
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert tr.state.step == STEPS and tr.optimizer.count == STEPS
    st = tr.optimizer.state_dict()["optimizer"]["state"]
    for i, s in opt_before["optimizer"]["state"].items():
        torch.testing.assert_close(st[i]["exp_avg_sq"], s["exp_avg_sq"], rtol=0, atol=0)

    tr2 = Trainer(TINY, _trainer_config(tr.cfg.output_dir, load_dir=tr._ckpt_dir()),
                  GROUPS, tr.datamanager, device="cpu")
    assert tr2.state.step == STEPS
    for k, v in tr2.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    tr2.cfg.max_num_iterations = STEPS + 2                  # resumes at its step
    tr2.train()
    assert tr2.state.step == STEPS + 2


def test_trainer_refuses_an_eval_cadence_it_cannot_run(scene, tmp_path):
    """The eval cadence is ported, so the trainer refuses none: a cadence
    that fires builds and runs (``tests/test_torch_trainer_eval.py`` holds
    it against the JAX trainer)."""
    from samnerf_tpu_torch.utils import writer
    tr = Trainer(TINY, dataclasses.replace(_trainer_config(tmp_path),
                                           steps_per_eval_batch=20),
                 GROUPS, DataManager(_dm_config(scene)), device="cpu")
    writer.write_out_storage()
    tr.eval_iteration(20)
    assert [e["name"] for e in writer._EVENTS] == ["Eval Loss", "Eval Loss Dict"]
    writer.write_out_storage()


def _jax_dm(scene):
    return JaxDataManager(JaxDMConfig(
        dataparser=JaxDPConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=256, patch_size=2, distill_sam=True,
        use_clipseg_feature=True))


def test_host_batches_match_jax(scene):
    """The host arrays every batch is drawn from: cameras, images and
    feature maps equal the JAX package's DataManager's."""
    jdm = _jax_dm(scene)
    dm = DataManager(_dm_config(scene))
    np.testing.assert_allclose(dm.cameras.camera_to_worlds.numpy(),
                               jdm.cameras.camera_to_worlds, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(dm.images, jdm.images)
    np.testing.assert_array_equal(dm.sam_features, jdm.sam_loader.features)
    np.testing.assert_array_equal(dm.clipseg_features, jdm.clipseg_loader.features)


@pytest.mark.parametrize("patch_size", [1, 2])
def test_device_batches_match_jax(scene, patch_size):
    """The trainer's batch path on the same uniform draws as the JAX
    package's ``device_data.sample_batch``: the same indices and targets,
    exactly."""
    jdm = _jax_dm(scene)
    dm = DataManager(_dm_config(scene))
    jdata = jax_device_data.build_device_dataset(jdm)
    data = build_device_dataset(dm, "cpu")
    key = jax.random.PRNGKey(11)
    ref = jax_device_data.sample_batch(key, jdata, 256, patch_size, (32, 32))
    u = np.array(jax.random.uniform(key, uniform_shape(256, patch_size)))
    batch = gather_batch(data, indices_from_uniform(torch.from_numpy(u), 6, 32, 32,
                                                    patch_size), patch_size, (32, 32))
    assert set(batch) == set(ref) == {"indices", "image", "sam", "clipseg"}
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_device_batches_are_patch_major(scene):
    dm = DataManager(_dm_config(scene))
    data = build_device_dataset(dm, "cpu")
    batch = sample_batch(torch.Generator().manual_seed(0), data, 256, 2, (32, 32))
    idx = batch["indices"].reshape(-1, 2, 2, 3)
    assert (idx[:, :, :, 0] == idx[:, :1, :1, 0]).all()
    assert (idx[:, 1, :, 1] == idx[:, 0, :, 1] + 1).all()
    assert (idx[:, :, 1, 2] == idx[:, :, 0, 2] + 1).all()
    i = batch["indices"].numpy()
    np.testing.assert_array_equal(batch["image"].numpy(),
                                  dm.images[i[:, 0], i[:, 1], i[:, 2]] / np.float32(255))
    c = idx[:, 1, 1].numpy()
    np.testing.assert_array_equal(patch_centers(batch["indices"], 2).numpy(), c)
    fs = dm.sam_features.shape[1] / 32                # nearest at scaled coords
    np.testing.assert_array_equal(batch["sam"].numpy(), dm.sam_features[
        c[:, 0], (c[:, 1] * fs).astype(int), (c[:, 2] * fs).astype(int)])
    fc = dm.clipseg_features.shape[1] / 32
    np.testing.assert_array_equal(batch["clipseg"].numpy(), dm.clipseg_features[
        i[:, 0], (i[:, 1] * fc).astype(int), (i[:, 2] * fc).astype(int)])


def test_cli_parses_the_preset_and_overrides(tmp_path):
    cfg = train_cli.parse(["samnerf_distill", "--data", str(tmp_path),
                           "--trainer.max-num-iterations", "7",
                           "--model.hash-fn", "reference",
                           "--datamanager.train-num-rays-per-batch=4096"])
    assert cfg.datamanager.dataparser.data == tmp_path
    assert cfg.trainer.max_num_iterations == 7
    assert cfg.model.hash_fn == "reference" and cfg.model.patch_size == 4
    assert cfg.optimizers["fields"].lr == 1e-2 and cfg.optimizers["conv"].lr == 5e-4
    assert cfg.datamanager.train_num_rays_per_batch == 4096
    assert cfg.model.num_sam_samples == 16 and cfg.model.use_clipseg_feature
    with pytest.raises(SystemExit):
        train_cli.parse(["nope"])
    with pytest.raises(SystemExit):
        train_cli.parse(["samnerf_distill", "--trainer.no-such-field", "1"])
