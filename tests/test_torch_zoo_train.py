"""The model zoo's registry, data and entry point in the port, on the CPU:
``zoo_methods()`` against the JAX registry, the occupancy schedule
against the JAX ``train_zoo``'s chunked condition, the depth and
semantic channels gathered on the device at JAX's ``next_train``
indices (bit for bit), the variable-resolution datamanager's batches
against JAX's, and ``train.main`` for every zoo method end to end on a
tiny synthetic scene with tiny model configs patched in (as the
entry-point tests of earlier slices patch ``_VIT_SPECS``).
"""
import functools
import math

import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.configs import zoo as jzoo
from samnerf_tpu.data import datamanagers_extra as jdme
from samnerf_tpu.data.datamanager import DataManagerConfig as JDMConfig
from samnerf_tpu.data.dataparser import DataparserConfig as JDPConfig
from samnerf_tpu_torch import train as ttrain
from samnerf_tpu_torch.configs import zoo as tzoo
from samnerf_tpu_torch.data import datamanagers_extra as tdme
from samnerf_tpu_torch.data.datamanager import DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.data.device_data import build_device_dataset, gather_batch
from samnerf_tpu_torch.utils.synthetic import write_scene

torch.set_num_threads(1)

SIZE = 24
NUM_CLASSES = 16


def _write_extras(scene, depth_format="npy"):
    """Seeded depths (``.npy`` metres or 16-bit ``.png`` millimetres) and
    16-class semantic masks beside the scene's images."""
    rng = np.random.default_rng(0)
    (scene / "depths").mkdir(exist_ok=True)
    (scene / "semantics").mkdir(exist_ok=True)
    for img in sorted((scene / "images").glob("*.png")):
        depth = rng.uniform(0.5, 3.0, (SIZE, SIZE)).astype(np.float32)
        depth[0, :4] = 0.0                                    # pixels without depth
        if depth_format == "npy":
            np.save(scene / "depths" / f"{img.stem}.npy", depth)
        else:
            mm = np.round(depth * 1000).astype(np.uint16)
            Image.fromarray(mm).save(scene / "depths" / f"{img.stem}.png")
        classes = rng.integers(0, NUM_CLASSES, (SIZE, SIZE)).astype(np.uint8)
        Image.fromarray(classes).save(scene / "semantics" / f"{img.stem}.png")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    s = write_scene(tmp_path_factory.mktemp("zoo") / "scene", num_train=3, num_test=1,
                    h=SIZE, w=SIZE)
    _write_extras(s)
    return s


def test_zoo_methods_match_jax():
    ours, ref = tzoo.zoo_methods(), jzoo.zoo_methods()
    assert list(ours) == list(ref)
    for name, m in ours.items():
        r = ref[name]
        assert (m.name, m.lr, m.use_occupancy, m.loss_needs_config, m.loss_needs_params) \
            == (r.name, r.lr, r.use_occupancy, r.loss_needs_config, r.loss_needs_params), name


@pytest.mark.parametrize("chunk", [16, 2])
def test_occupancy_schedule_matches_jax(chunk):
    """JAX updates before the chunk starting at step ``start`` when start >
    256 and (start - 1) % 16 < chunk (``samnerf_tpu/train.py:235``)."""
    steps = 1000
    ref = {c * chunk + 1 for c in range(-(-steps // chunk))
           if c * chunk + 1 > 256 and (c * chunk) % 16 < chunk}
    ours = {s for s in range(1, steps + 1) if ttrain.occupancy_update_due(s)}
    assert ours == ref
    assert {257, 273} <= ours and min(ours) == 257


@pytest.mark.parametrize("depth_format", ["npy", "png"])
def test_extra_channels_match_jax_next_train(tmp_path, depth_format):
    scene = write_scene(tmp_path / "scene", num_train=3, num_test=1, h=SIZE, w=SIZE)
    _write_extras(scene, depth_format)
    for jcls, tcls, key in ((jdme.DepthDataManager, tdme.DepthDataManager, "depth_image"),
                            (jdme.SemanticDataManager, tdme.SemanticDataManager,
                             "semantics")):
        jdm = jcls(JDMConfig(dataparser=JDPConfig(data=scene, train_val_json_split=True),
                             train_num_rays_per_batch=256), seed=3)
        tdm = tcls(DataManagerConfig(dataparser=DataparserConfig(
            data=scene, train_val_json_split=True), train_num_rays_per_batch=256), seed=3)
        ref = jdm.next_train(0)
        data = build_device_dataset(tdm, "cpu")
        got = gather_batch(data, torch.from_numpy(ref["indices"]).long(), 1, (SIZE, SIZE))
        np.testing.assert_array_equal(got[key].numpy(), ref[key])
        np.testing.assert_array_equal(got["image"].numpy(), ref["image"])
        assert got[key].shape == (256, 1)
    assert (ref["semantics"] >= 0).all() and (ref["semantics"] < NUM_CLASSES).all()


def test_variable_res_batches_match_jax(scene):
    jdm = jdme.VariableResDataManager(JDMConfig(
        dataparser=JDPConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=64), seed=5)
    tdm = tdme.VariableResDataManager(DataManagerConfig(
        dataparser=DataparserConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=64), seed=5)
    assert tdm.num_train_images == 3 and tdm.images is None
    for step in range(3):
        ref, got = jdm.next_train(step), tdm.next_train(step)
        for k in ("indices", "image"):
            np.testing.assert_array_equal(got[k], ref[k])


TINY_BASE = dict(distill_sam=False, num_levels=2, max_res=32, log2_hashmap_size=10,
                 num_proposal_samples_per_ray=(8,), num_nerf_samples_per_ray=8,
                 proposal_net_args=({"hidden_dim": 8, "log2_hashmap_size": 10,
                                     "num_levels": 2, "max_res": 32},))


def tiny_configs(monkeypatch):
    """Patch every zoo method's default config to a tiny one."""
    from samnerf_tpu_torch.models import (depth_nerfacto, instant_ngp, mipnerf, nerfplayer,
                                          semantic_nerfw, tensorf, vanilla_nerf)
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig
    patches = [
        (vanilla_nerf, "VanillaNerfConfig", dict(num_coarse_samples=4,
                                                 num_importance_samples=4, hidden_dim=16)),
        (mipnerf, "MipNerfConfig", dict(num_coarse_samples=4, num_importance_samples=4,
                                        hidden_dim=16, pos_frequencies=4)),
        (instant_ngp, "InstantNGPConfig", dict(num_samples=8, num_levels=2, max_res=32,
                                               log2_hashmap_size=10)),
        (tensorf, "TensoRFConfig", dict(num_uniform_samples=8, num_samples=4, resolution=8,
                                        density_components=2, color_components=2,
                                        appearance_dim=4)),
        (depth_nerfacto, "DepthNerfactoConfig", dict(base=SAMModelConfig(**TINY_BASE))),
        (semantic_nerfw, "SemanticNerfWConfig", dict(base=SAMModelConfig(**TINY_BASE))),
        (nerfplayer, "NerfPlayerConfig", dict(num_samples=8, num_levels=2, max_res=32,
                                              log2_hashmap_size=10, num_time_steps=2,
                                              hidden_dim=8)),
    ]
    for mod, name, kw in patches:
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))


def _main(name, scene, out, steps, capsys, extra=()):
    runs, losses = [], []
    rc = ttrain.main([name, "--data", str(scene), "--max-num-iterations", str(steps),
                      "--rays-per-batch", "64", "--output-dir", str(out), "--log-every", "1",
                      *extra], device="cpu",
                     step_callback=lambda s, m: losses.append(float(m["total_loss"])),
                     run_callback=runs.append)
    assert rc == 0
    return runs[0], losses, capsys.readouterr().out


@pytest.mark.parametrize("name", list(jzoo.zoo_methods()))
def test_main_trains_each_zoo_method(name, scene, tmp_path, monkeypatch, capsys):
    tiny_configs(monkeypatch)
    run, losses, out = _main(name, scene, tmp_path / "out", 2, capsys)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert run.out_dir.parent == tmp_path / "out" / scene.name / name
    ckpt = torch.load(run.checkpoint, weights_only=True)
    assert ckpt["step"] == 2 and ckpt["method"] == name
    model, _ = tzoo.zoo_methods()[name].build(device="cpu")
    model.load_state_dict(ckpt["model"])
    assert run.psnr is not None and math.isfinite(run.psnr)
    assert f"eval view 0 PSNR: {run.psnr:.2f}" in out and "step 2: loss=" in out
    extra = {"depth-nerfacto": "depth_loss", "semantic-nerfw": "semantics_loss"}.get(name)
    if extra:
        assert extra in run.metrics


def test_main_updates_the_occupancy_grid(scene, tmp_path, monkeypatch, capsys):
    """With the warm-up at 0, instant-NGP updates its grid before steps 1
    and 17 of 18 (every 16 after it), renders eval with it and saves it."""
    tiny_configs(monkeypatch)
    monkeypatch.setattr(ttrain, "OCC_WARMUP", 0)
    run, _, _ = _main("instant-ngp", scene, tmp_path / "out", 18, capsys)
    assert [s for s, _ in run.occupancy_updates] == [1, 17]
    assert all(0.0 < share <= 1.0 for _, share in run.occupancy_updates)
    grid = torch.load(run.checkpoint, weights_only=True)["occupancy"]
    assert grid.shape == (ttrain.OCC_RES,) * 3
    assert float(grid.mean()) == run.occupancy_updates[-1][1]


def test_help_lists_the_zoo(capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.parse(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "| zoo: " + ", ".join(jzoo.zoo_methods()) in out
    assert "The model zoo waits" not in out


def test_main_without_eval_images(tmp_path, monkeypatch, capsys):
    """A scene with no test split trains and saves without an eval PSNR
    (the JAX DataManager raises IndexError on such a scene)."""
    tiny_configs(monkeypatch)
    scene = write_scene(tmp_path / "scene", num_train=3, num_test=0, h=SIZE, w=SIZE)
    run, losses, out = _main("tensorf", scene, tmp_path / "out", 2, capsys)
    assert run.psnr is None and run.eval_ms is None and run.checkpoint.exists()
    assert "no eval images, no PSNR" in out and len(losses) == 2
