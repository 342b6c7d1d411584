"""The port's in-training eval cadence and event writers on the CPU,
against the JAX package's names and rules.

- ``Trainer.eval_iteration`` fires as ``tests/test_trainer.py``'s
  ``test_eval_cadence_fires`` checks the JAX trainer, with the same event
  names;
- ``Trainer._crossed`` equals the JAX trainer's on a grid of
  ``(step, n, every)``;
- ``JsonWriter`` rows have the JAX writer's keys and values for the same
  events;
- ``train_loop`` with ``vis`` set writes ``metrics.json`` with the eval
  events, and each ``vis`` token sets up its writer.
Everything here is exact (names, steps, row keys); no tolerance.
"""
import dataclasses
import importlib.util
import itertools
import json

import numpy as np
import pytest

from samnerf_tpu.engine.trainer import Trainer as JaxTrainer
from samnerf_tpu.utils import writer as jwriter
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
from samnerf_tpu_torch.utils import synthetic, writer

from test_torch_train_slice import GROUPS, TINY


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.write_scene(tmp_path_factory.mktemp("scene"), num_train=4,
                                 num_test=2, h=32, w=32, with_features=True,
                                 feature_long_side=8)


def _dm_config(scene):
    return DataManagerConfig(
        dataparser=DataparserConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=128, eval_num_rays_per_batch=128, patch_size=2,
        distill_sam=True, use_clipseg_feature=True)


@pytest.fixture()
def clean_writer():
    writer.reset()
    writer.write_out_storage()
    yield writer
    writer.reset()
    writer.write_out_storage()


def test_event_names_match_jax():
    assert {e.name: e.value for e in writer.EventName} == \
        {e.name: e.value for e in jwriter.EventName}


def test_crossed_matches_jax():
    for step, n, every in itertools.product(range(0, 45), (1, 2, 5, 20), (0, 1, 3, 10, 20)):
        if n > step:
            continue
        assert Trainer._crossed(step, n, every) == JaxTrainer._crossed(step, n, every), \
            (step, n, every)


def test_json_rows_match_jax(tmp_path, clean_writer):
    """The same events through both writer modules give the same rows."""
    img = np.zeros((4, 4, 3), np.float32)

    def emit(w):
        w.put_scalar(w.EventName.CURR_TEST_PSNR, 21.5, 3)
        w.put_dict("Eval Loss Dict", {"rgb_loss": 0.25}, 3)
        w.put_time(w.EventName.ITER_TRAIN_TIME, 0.125, 4)
        w.put_time(w.EventName.TEST_RAYS_PER_SEC, 1000.0, 4, avg_over_steps=False)
        w.put_image("Eval Images/img", img, 4)
        w.write_out_storage()
        w.finalize()

    rows = {}
    for name, w in (("port", writer), ("jax", jwriter)):
        w.reset()
        w.setup_event_writer("json", tmp_path / name)
        (tmp_path / name).mkdir()
        emit(w)
        rows[name] = json.loads((tmp_path / name / "metrics.json").read_text())
        w.reset()
    assert rows["port"] == rows["jax"]
    assert [r["name"] for r in rows["port"]] == [
        "Test PSNR", "Eval Loss Dict/rgb_loss", "Train Iter (time)", "Test Rays / Sec"]
    assert writer.GLOBAL_BUFFER["events"]["Train Iter (time)"]["avg"] == \
        jwriter.GLOBAL_BUFFER["events"]["Train Iter (time)"]["avg"] == 0.125


@pytest.fixture(scope="module")
def trainer(scene, tmp_path_factory):
    cfg = TrainerConfig(max_num_iterations=6, steps_per_save=100000, log_every=3,
                        steps_per_eval_batch=2, steps_per_eval_image=3,
                        output_dir=tmp_path_factory.mktemp("out"))
    return Trainer(TINY, cfg, GROUPS, DataManager(_dm_config(scene)), device="cpu")


def test_eval_cadence_fires(trainer, clean_writer):
    """As ``tests/test_trainer.py::test_eval_cadence_fires``: an eval batch
    at a multiple of steps_per_eval_batch, an eval image (with PSNR) where
    a block of n steps crosses a multiple of steps_per_eval_image."""
    trainer.cfg = dataclasses.replace(trainer.cfg, steps_per_eval_batch=10,
                                      steps_per_eval_image=20)
    trainer.eval_iteration(10, n=1)
    names = [e["name"] for e in writer._EVENTS]
    assert "Eval Loss" in names and "Eval Loss Dict" in names
    assert writer.EventName.CURR_TEST_PSNR.value not in names
    trainer.eval_iteration(20, n=5)
    names = [e["name"] for e in writer._EVENTS]
    assert writer.EventName.CURR_TEST_PSNR.value in names
    assert writer.EventName.TEST_RAYS_PER_SEC.value in names
    assert sorted(n for n in names if n.startswith("Eval Images/")) == [
        "Eval Images/accumulation", "Eval Images/depth", "Eval Images/img"]
    step, metrics = trainer.metrics_history[-1]
    assert step == 20 and np.isfinite(metrics["psnr"]) and -1 <= metrics["ssim"] <= 1
    img = next(e["event"] for e in writer._EVENTS if e["name"] == "Eval Images/img")
    assert img.shape == (32, 64, 3)
    trainer.eval_iteration(21, n=1)                  # crosses nothing
    assert [e["name"] for e in writer._EVENTS] == names
    writer.write_out_storage()


def test_eval_image_index_cycles_as_jax(trainer, monkeypatch):
    """The eval image of step s is (s // steps_per_eval_image) % n_eval."""
    seen = []
    pipe = trainer._pipeline()
    monkeypatch.setattr(pipe, "get_eval_image_metrics_and_images",
                        lambda i: (seen.append(i), ({"psnr": 0.0, "num_rays": 1}, {}))[1])
    trainer.cfg = dataclasses.replace(trainer.cfg, steps_per_eval_batch=0,
                                      steps_per_eval_image=3)
    for step in range(1, 13):
        trainer.eval_iteration(step)
    writer.write_out_storage()
    assert seen == [(s // 3) % 2 for s in (3, 6, 9, 12)] == [1, 0, 1, 0]


def test_train_loop_writes_eval_events(scene, tmp_path, clean_writer, capsys,
                                       monkeypatch):
    """The train entry with both cadences firing and ``vis="json+viewer"``:
    ``metrics.json`` holds the train, eval-batch and eval-image events at
    their steps; the viewer attaches on free ports (seeded SAM weights,
    with the notice), its step callback runs after every step, each step
    holds the train lock, and the viewer is stopped when training ends."""
    from samnerf_tpu_torch.viewer.viewer_state import ViewerState

    calls = {"steps": [], "stopped": 0, "locked": []}
    step_callback, stop, iteration = (ViewerState.step_callback, ViewerState.stop,
                                      Trainer.train_iteration)

    def on_step(self, step, metrics=None):
        calls["steps"].append(step)
        return step_callback(self, step, metrics)

    def on_stop(self):
        calls["stopped"] += 1
        return stop(self)

    def on_iteration(self, step):
        calls["locked"].append(self.train_lock.locked())
        return iteration(self, step)

    monkeypatch.setattr(ViewerState, "step_callback", on_step)
    monkeypatch.setattr(ViewerState, "stop", on_stop)
    monkeypatch.setattr(Trainer, "train_iteration", on_iteration)
    monkeypatch.delenv("SAM_CHECKPOINT", raising=False)
    monkeypatch.chdir(tmp_path)             # no ./checkpoints/ here
    config = method_configs()["samnerf_distill"]
    config.model = TINY
    config.datamanager = _dm_config(scene)
    config.optimizers = GROUPS
    config.trainer = TrainerConfig(max_num_iterations=4, steps_per_save=100000,
                                   log_every=2, steps_per_eval_batch=2,
                                   steps_per_eval_image=3, output_dir=tmp_path)
    config.vis = "json+viewer"
    config.websocket_port = config.http_port = 0
    tr = train_cli.train_loop(config, device="cpu")
    out = capsys.readouterr().out
    assert "viewer unavailable" not in out
    assert "viewer: no SAM checkpoint found" in out and "viewer: http://localhost:" in out
    assert calls == {"steps": [1, 2, 3, 4], "stopped": 1, "locked": [True] * 4}
    rows = json.loads((tmp_path / "metrics.json").read_text())
    steps = {}
    for r in rows:
        steps.setdefault(r["name"], []).append(r["step"])
    assert steps["Train Iter (time)"] == [1, 2, 3, 4]
    assert steps["Rays / Sec"] == [2, 3, 4]
    assert steps["Eval Loss"] == steps["Eval Loss Dict/rgb_loss"] == [2, 4]
    assert steps["Test PSNR"] == steps["Eval Images Metrics/psnr"] == [3]
    assert steps["Eval Images Metrics/ssim"] == steps["Test Rays / Sec"] == [3]
    assert steps["Train Loss Dict/total_loss"] == steps["Train Loss Dict/sam_loss"] == [2, 4]
    assert all(np.isfinite(r["value"]) for r in rows)
    assert tr.state.step == 4 and (tmp_path / "samnerf_tpu_torch_ckpts"
                                   / "step-000000004.pt").exists()


class _FakeTensorboard(writer.Writer):
    """Stands in for ``TensorboardWriter``: importing tensorboard loads
    TensorFlow where it is installed (over 10 s on a CPU)."""

    def __init__(self, log_dir):
        self.log_dir, self.rows = log_dir, []

    def write_scalar(self, name, value, step):
        self.rows.append((name, value, step))


def test_vis_tokens_set_up_their_writers(tmp_path, clean_writer, monkeypatch):
    monkeypatch.setattr(writer, "TensorboardWriter", _FakeTensorboard)
    config = method_configs()["samnerf_distill"]
    assert config.vis == "viewer"
    config.trainer.output_dir = tmp_path
    config.vis = "json+tensorboard"
    train_cli._setup_vis(config)
    tb, js = writer._WRITERS
    assert isinstance(tb, _FakeTensorboard) and tb.log_dir == tmp_path
    assert isinstance(js, writer.JsonWriter)
    writer.put_scalar("Eval Loss", 1.5, 7)
    writer.write_out_storage()
    assert tb.rows == [("Eval Loss", 1.5, 7)]
    train_cli._setup_vis(dataclasses.replace(config, vis="json"))   # flushes the last run
    assert json.loads((tmp_path / "metrics.json").read_text()) == [
        {"name": "Eval Loss", "value": 1.5, "step": 7}]
    assert [type(w).__name__ for w in writer._WRITERS] == ["JsonWriter"]
    assert train_cli.parse(["samnerf_distill", "--vis", "json"]).vis == "json"
    if importlib.util.find_spec("wandb") is None:
        with pytest.raises(ImportError, match="wandb"):
            train_cli._setup_vis(dataclasses.replace(config, vis="wandb"))
