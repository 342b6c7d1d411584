"""One dispatch per block of training steps and per serve frame on the
card (``cuda`` marker; they skip without one): CUDA graphs against the
eager path they capture, at small widths.

This file imports torch and the port only, so it runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dispatch.py

- A small ``Trainer`` with ``steps_per_dispatch=4``: its first block runs
  eagerly and is captured; from that state two graph replays and eight
  eager steps of the same update (blocks of one step) give the same step
  counts, and losses, parameters and moments that differ no more than two
  eager runs of the eight steps differ from each other (F32-ENC-BWD sums
  table gradients with atomics, in a run-to-run order), within a floor of
  ``TOL_REL`` (relative L2 per tensor; losses ``TOL_LOSS`` relative).  The
  replays make no launch from Python, and a profiler trace of them holds
  the kernels the eight eager steps launched, by name; a loaded optimizer
  state is captured anew.
- ``serve_frame_fn`` of a small model with f32, int8 and fused int8
  tables, and culled by an occupancy grid: each graphed frame's image and
  mask equal the eager frame's bit for bit on three cameras and clicks; a
  frame's first call launches an eager frame and captures it, a replay
  launches nothing from Python, and its trace holds the eager frame's
  kernels.  Baking the tables again replaces the frame's graph.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.engine.optimizers import OptimizerGroupConfig
from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
from samnerf_tpu_torch.models.sam_model import SAMModelConfig
from samnerf_tpu_torch.ops import kernel_launches
from samnerf_tpu_torch.utils import synthetic

SMALL = SAMModelConfig(
    num_levels=8, max_res=256, log2_hashmap_size=14,
    num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
    proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                        "num_levels": 4, "max_res": 64},),
    hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
    hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=2, hash_fn="morton")
GROUPS = {g: OptimizerGroupConfig(lr=1e-2, lr_final=5e-4, max_steps=200)
          for g in ("proposal_networks", "fields")}
GROUPS.update({g: OptimizerGroupConfig(lr=5e-3, lr_final=1e-4, max_steps=200)
               for g in ("sam_field", "conv")})
BLOCK = 4
TOL_LOSS = 1e-4
TOL_REL = 1e-6


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _trainer(scene, out, n, dev):
    dm = DataManager(DataManagerConfig(
        dataparser=DataparserConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=1024, patch_size=2, distill_sam=True,
        use_clipseg_feature=True))
    cfg = TrainerConfig(max_num_iterations=1000, steps_per_save=100000,
                        steps_per_eval_batch=0, steps_per_eval_image=0,
                        output_dir=out, steps_per_dispatch=n, save_final=False)
    return Trainer(SMALL, cfg, GROUPS, dm, device=dev)


def _launched(fn):
    """``fn()``: its result and the launches the kernel wrappers made."""
    kernel_launches.reset()
    out = fn()
    return out, kernel_launches.counts()


def _on_card(fn):
    """``fn()`` under the profiler: its result and the registered kernels
    that ran on the card, by name (graph replays included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, kernel_launches.trace_counts(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA)


def _snapshot(tr):
    return (copy.deepcopy(tr.model.state_dict()), copy.deepcopy(tr.optimizer.state_dict()),
            dataclasses.replace(tr.state), tr.generator.get_state())


def _restore(tr, snap):
    model, opt, state, gen = snap
    tr.model.load_state_dict(model)
    tr.optimizer.load_state_dict(copy.deepcopy(opt))
    tr.state = dataclasses.replace(state)
    tr.generator.set_state(gen)


def _rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def _distance(a, b):
    """Worst relative L2 distance over parameters and moments."""
    worst = max(_rel(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for name, s in sa["optimizer"]["state"].items():
        t = sb["optimizer"]["state"][name]
        assert float(s["step"]) == float(t["step"])
        worst = max(worst, _rel(s["exp_avg"], t["exp_avg"]),
                    _rel(s["exp_avg_sq"], t["exp_avg_sq"]))
    assert sa["count"] == sb["count"] and a.state == b.state
    return worst


@pytest.mark.cuda
def test_a_block_replay_is_its_eager_steps(tmp_path):
    dev = _cuda()
    scene = synthetic.write_scene(tmp_path / "scene", num_train=6, num_test=1, h=64, w=64,
                                  with_features=True, feature_long_side=16)
    graphed = _trainer(scene, tmp_path / "g", BLOCK, dev)
    graphed.run_block(BLOCK)                        # eager, then captured
    assert graphed._graph is not None
    snap = _snapshot(graphed)
    eager = []
    for k in range(2):
        tr = _trainer(scene, tmp_path / f"e{k}", BLOCK, dev)
        _restore(tr, snap)
        losses, steps = _launched(lambda: [float(tr.run_block(1)["total_loss"])
                                           for _ in range(2 * BLOCK)])
        eager.append((tr, losses))
    graph = graphed._graph
    (graph_losses, python), on_card = _on_card(lambda: _launched(
        lambda: [float(graphed.run_block(BLOCK)["total_loss"]) for _ in range(2)]))
    assert graphed._graph is graph                  # replayed, not captured again
    assert graphed.steps_by_dispatch == {"eager": BLOCK, "captured": BLOCK,
                                         "replayed": 2 * BLOCK}
    assert not any(python.values())
    assert on_card == steps and steps["F32-ENC"] and steps["F32-ENC-BWD"]
    (e1, l1), (e2, l2) = eager
    spread = _distance(e1, e2)
    gap = _distance(graphed, e1)
    print(f"block replay vs eager steps: {gap:.3e} (two eager runs: {spread:.3e})")
    assert gap <= max(4 * spread, TOL_REL)
    for got, want in zip(graph_losses, (l1[BLOCK - 1], l1[-1])):
        assert abs(got - want) <= TOL_LOSS * abs(want)
    # a loaded optimizer state has new moments: the block is captured anew
    _restore(graphed, snap)
    graphed.run_block(BLOCK)
    assert graphed._graph is not graph and graphed._graph_key == graphed._tensors_key()


def _cameras(dev, i, size):
    from samnerf_tpu_torch.core.cameras import Cameras
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:, 3] = [0.03 * i, -0.02 * i, 1.5 - 0.05 * i]
    f = 50.0 * size / 64
    return Cameras(camera_to_worlds=torch.as_tensor(c2w[None]),
                   fx=torch.tensor([[f]]), fy=torch.tensor([[f]]),
                   cx=torch.tensor([[size / 2.0]]), cy=torch.tensor([[size / 2.0]]),
                   width=size, height=size).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["f32", "int8", "int8_fused", "culled"])
def test_a_serve_frame_replay_is_the_eager_frame(route):
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.ops.occupancy import pack_serve_occupancy
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.utils.init import init_state

    dev = _cuda()
    size = 64
    cfg = dataclasses.replace(SMALL, hash_q8_serve=route != "f32",
                              serve_fuse_mlp=route in ("int8_fused", "culled"),
                              occ_res=32)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                     torch.Generator().manual_seed(1), device=dev,
                                     table_scale=0.5))
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(2), dev))
    snr = SamNerfRenderer(model, chunk=1024, serve_preset="static")
    if route != "f32":
        snr.bake_serve_tables()
    if route == "culled":
        cells = np.zeros((32,) * 3, np.float32)
        cells[8:24, 8:24, 8:24] = 1.0
        snr.occ = pack_serve_occupancy(cells, device=dev)
    serve = snr.serve_frame_fn(sam, size, size)
    for i, click in enumerate([(20.0, 40.0), (32.0, 32.0), (50.0, 10.0)]):
        cams = _cameras(dev, i, size)
        (want, eager), eager_on_card = _on_card(
            lambda: _launched(lambda: serve.eager(cams, 0, click, return_mask=True)))
        assert eager_on_card == eager and any(eager.values())
        if i == 0:      # the first call runs one eager frame, then captures it
            got, python = _launched(lambda: serve(cams, 0, click, return_mask=True))
            assert python == {k: 2 * n for k, n in eager.items()}
        else:
            (got, python), on_card = _on_card(
                lambda: _launched(lambda: serve(cams, 0, click, return_mask=True)))
            assert not any(python.values()) and on_card == eager
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert len(serve.graphs) == 1
    if route == "int8":
        # new table buffers: the frame is captured anew, in place of the old graph
        old = serve.graphs[next(iter(serve.graphs))][2]
        snr.bake_serve_tables()
        got = serve(cams, 0, click, return_mask=True)
        assert len(serve.graphs) == 1 and serve.graphs[next(iter(serve.graphs))][2] is not old
        for g, w in zip(got, serve.eager(cams, 0, click, return_mask=True)):
            assert torch.equal(g, w)
