"""The port's ``VanillaPipeline`` and eval batches against the JAX
package's on the CPU, on ``tests/test_pipeline.py``'s ``TINY`` model with
the same flax weights (``convert.params_from_jax``) and a 16x16 synthetic
scene.

Eval batches are drawn on the host from the DataManager's numpy
generator in both packages, so one seed gives the same indices (held
exactly).  Tolerances: the eval loss dict rtol 1e-4 (f32 sums in another
order through proposal sampling and two MLPs, as the train-step test);
the eval image's rgb atol 1e-4, its psnr and ssim rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from samnerf_tpu.data.datamanager import (DataManager as JaxDataManager,
                                          DataManagerConfig as JaxDMConfig)
from samnerf_tpu.data.dataparser import DataparserConfig as JaxDPConfig
from samnerf_tpu.engine.pipeline import VanillaPipeline as JaxPipeline
from samnerf_tpu.models.sam_model import SAMModel as JaxModel
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.engine.pipeline import VanillaPipeline
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.utils import synthetic

from test_pipeline import TINY
from test_torch_convert import port_config
from test_torch_serve_slice import _model_params


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.write_scene(tmp_path_factory.mktemp("s"), num_train=3, num_test=2,
                                 h=16, w=16)


def _dms(scene, seed=0):
    kw = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=96, patch_size=1,
              distill_sam=False)
    return (DataManager(DataManagerConfig(
                dataparser=DataparserConfig(data=scene, train_val_json_split=True), **kw),
                seed=seed),
            JaxDataManager(JaxDMConfig(
                dataparser=JaxDPConfig(data=scene, train_val_json_split=True), **kw),
                seed=seed))


@pytest.fixture(scope="module")
def pipelines(scene):
    params = _model_params(TINY, seed=3)
    model = SAMModel(port_config(TINY), device="cpu")
    model.load_state_dict(params_from_jax(params))
    dm, jdm = _dms(scene)
    return VanillaPipeline(model, dm), JaxPipeline(JaxModel(TINY), TINY, jdm), params


@pytest.mark.parametrize("seed", [0, 5])
def test_eval_batches_match_jax(scene, seed):
    dm, jdm = _dms(scene, seed)
    for step in range(3):
        ours, ref = dm.next_eval(step), jdm.next_eval(step)
        assert set(ours) == set(ref) == {"indices", "image"}
        for k in ours:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    ours, ref = dm.eval_image_batch(1), jdm.eval_image_batch(1)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_eval_loss_dict_matches_jax(pipelines):
    pipe, jpipe, params = pipelines
    pipe.datamanager.rng = np.random.default_rng(11)
    jpipe.datamanager.rng = np.random.default_rng(11)
    for step in (0, 1):
        ours = pipe.get_eval_loss_dict(step)
        ref = jpipe.get_eval_loss_dict(params, step)
        assert set(ours) == set(ref) == {"rgb_loss"}
        np.testing.assert_allclose(ours["rgb_loss"].item(), float(ref["rgb_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("index", [0, 1])
def test_eval_image_metrics_match_jax(pipelines, index):
    pipe, jpipe, params = pipelines
    metrics, images = pipe.get_eval_image_metrics_and_images(index)
    ref_metrics, ref_images = jpipe.get_eval_image_metrics_and_images(params, index)
    assert set(metrics) == set(ref_metrics) == {"psnr", "ssim", "num_rays"}
    assert metrics["num_rays"] == ref_metrics["num_rays"] == 256
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=1e-4, err_msg=k)
    assert set(images) == set(ref_images) == {"img", "depth", "accumulation"}
    assert images["img"].shape == (16, 32, 3)              # gt | pred side by side
    np.testing.assert_array_equal(images["img"][:, :16], ref_images["img"][:, :16])
    np.testing.assert_allclose(images["img"][:, 16:], np.asarray(ref_images["img"][:, 16:]),
                               atol=1e-4)
    np.testing.assert_allclose(images["accumulation"], np.asarray(ref_images["accumulation"]),
                               atol=1e-4)


def test_train_losses_and_the_fallback_without_an_eval_split(pipelines, monkeypatch):
    pipe, _, _ = pipelines
    losses = pipe.get_train_loss_dict(0, torch.Generator().manual_seed(0))
    assert set(losses) == {"rgb_loss", "interlevel_loss", "distortion_loss"}
    assert all(np.isfinite(v.item()) and not v.requires_grad for v in losses.values())
    again = pipe.get_train_loss_dict(0, torch.Generator().manual_seed(0))
    assert {k: v.item() for k, v in again.items()} == {k: v.item() for k, v in losses.items()}
    monkeypatch.setattr(pipe.datamanager, "eval_images", None)
    fallback = pipe.get_eval_loss_dict(0, torch.Generator().manual_seed(0))
    assert {k: v.item() for k, v in fallback.items()} == {k: v.item() for k, v in losses.items()}


def test_param_groups_match_jax(pipelines):
    pipe, jpipe, params = pipelines
    ref = jpipe.get_param_groups(params)
    ours = pipe.get_param_groups()
    assert {g: [m.replace("proposal_networks_", "proposal_networks.") for m in ms]
            for g, ms in ref.items()} == ours == {"fields": ["fields"],
                                                 "proposal_networks": ["proposal_networks.0"]}
