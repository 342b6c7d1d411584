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
  replays make no launch from Python, and a profiler trace of a further
  replay holds per step the kernels the eager steps launched, by name; a
  loaded optimizer state is captured anew.
- ``serve_frame_fn`` of a small model with f32, int8 and fused int8
  tables, and culled by an occupancy grid: each graphed frame's image and
  mask equal the eager frame's bit for bit on three cameras and clicks; a
  frame's first call launches an eager frame and captures it, a replay
  launches nothing from Python, and its trace holds the eager frame's
  kernels.  Baking the tables again replaces the frame's graph.
- The same block and the sharded frame (``build_sharded_frame_fn`` with
  fused int8 tables, with and without a SAM decode) on a process group
  of one NCCL rank: the data-parallel block as the single card's, its
  gradient all-reduce inside the graph; each sharded frame replay equals
  the eager sharded frame bit for bit on three cameras and clicks, its
  first call launches an eager frame and captures it, a replay launches
  nothing from Python and its trace holds the eager frame's kernels.
- ``SamPredictor`` with a small encoder (one global layer on FLASH-RELPOS)
  against the same model with ``use_graphs=False``: each replayed
  ``set_image`` gives the eager embedding bit for bit, launches nothing
  from Python and runs one FLASH-RELPOS on the card; each replayed
  ``predict`` (buckets 1 and 4, with and without a box, multimask on and
  off) and ``predict_batched`` gives the eager masks, IoU and logits bit
  for bit; an embedding taken before a later ``set_image`` stays.
- Each zoo method at tiny widths: its first chunk runs eagerly and is
  captured; from that state one replayed chunk against the same chunk run
  eagerly three times (twice on the current stream, once on a side stream
  as the capture's own eager run: the atomics' order depends on the
  stream): parameters and moments within 4 times the eager runs' widest
  pairwise spread (F32-ENC-BWD's atomics, TensoRF's scatters) or
  ``TOL_REL``, at each of them, losses
  within ``TOL_LOSS``; the replay launches nothing from Python and a
  further one runs on the card the hash kernels the eager chunk launched.

A trace that comes back short of what ran is taken again (``_on_card``,
``kernel_launches.TRACE_TRIES``), each try held exactly.
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


def _on_card(fn, whole=None):
    """``fn()`` under the profiler: its result and the registered kernels
    that ran on the card, by name (graph replays included).  ``whole(out,
    counts)``: whether the trace holds what ``fn`` ran; while it says no,
    ``fn`` (then idempotent) runs again under a new trace, at most
    ``kernel_launches.TRACE_TRIES`` times, and the caller holds the last
    trace exactly."""
    out, trace = kernel_launches.traced(fn, whole=whole)
    return out, trace.counts


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


def _block_replay_is_its_eager_steps(tmp_path, dev):
    scene = synthetic.write_scene(tmp_path / "scene", num_train=6, num_test=1, h=64, w=64,
                                  with_features=True, feature_long_side=16)
    graphed = _trainer(scene, tmp_path / "g", BLOCK, dev)
    graphed.run_block(BLOCK)                        # eager, then captured
    assert list(graphed._graphs.graphs) == ["block"]
    snap = _snapshot(graphed)
    eager = []
    for k in range(2):
        tr = _trainer(scene, tmp_path / f"e{k}", BLOCK, dev)
        _restore(tr, snap)
        losses, steps = _launched(lambda: [float(tr.run_block(1)["total_loss"])
                                           for _ in range(2 * BLOCK)])
        eager.append((tr, losses))
    graph = graphed._graphs.graphs["block"][1]
    graph_losses, python = _launched(
        lambda: [float(graphed.run_block(BLOCK)["total_loss"]) for _ in range(2)])
    assert graphed._graphs.graphs["block"][1] is graph      # replayed, not captured again
    assert graphed.steps_by_dispatch == {"eager": BLOCK, "captured": BLOCK,
                                         "replayed": 2 * BLOCK}
    assert not any(python.values())
    (e1, l1), (e2, l2) = eager
    spread = _distance(e1, e2)
    gap = _distance(graphed, e1)
    print(f"block replay vs eager steps: {gap:.3e} (two eager runs: {spread:.3e})")
    assert gap <= max(4 * spread, TOL_REL)
    for got, want in zip(graph_losses, (l1[BLOCK - 1], l1[-1])):
        assert abs(got - want) <= TOL_LOSS * abs(want)
    # a further replay runs on the card the kernels of a block's eager steps
    _, on_card = _on_card(lambda: graphed.run_block(BLOCK),
                          lambda _, c: {k: 2 * v for k, v in c.items()} == steps)
    assert {k: 2 * v for k, v in on_card.items()} == steps
    assert steps["F32-ENC"] and steps["F32-ENC-BWD"]
    # a loaded optimizer state has new moments: the block is captured anew
    _restore(graphed, snap)
    graphed.run_block(BLOCK)
    held, new = graphed._graphs.graphs["block"]
    assert new is not graph and held == graphed.optimizer.held()
    return graphed


@pytest.mark.cuda
def test_a_block_replay_is_its_eager_steps(tmp_path):
    _block_replay_is_its_eager_steps(tmp_path, _cuda())


@pytest.fixture
def nccl_group():
    """A process group of one NCCL rank at a free local port."""
    import socket

    import torch.distributed as dist

    dev = _cuda()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_a_data_parallel_block_replay_is_its_eager_steps(tmp_path, nccl_group):
    graphed = _block_replay_is_its_eager_steps(tmp_path, nccl_group)
    assert graphed.distributed


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
            lambda: _launched(lambda: serve.eager(cams, 0, click, return_mask=True)),
            lambda out, c: c == out[1])
        assert eager_on_card == eager and any(eager.values())
        if i == 0:      # the first call runs one eager frame, then captures it
            got, python = _launched(lambda: serve(cams, 0, click, return_mask=True))
            assert python == {k: 2 * n for k, n in eager.items()}
        else:
            (got, python), on_card = _on_card(
                lambda: _launched(lambda: serve(cams, 0, click, return_mask=True)),
                lambda _, c: c == eager)
            assert not any(python.values()) and on_card == eager
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert len(serve.graphs) == 1
    if route == "int8":
        # new table buffers: the frame is captured anew, in place of the old graph
        old = serve.graphs[next(iter(serve.graphs))][1]
        snr.bake_serve_tables()
        got = serve(cams, 0, click, return_mask=True)
        assert len(serve.graphs) == 1 and serve.graphs[next(iter(serve.graphs))][1] is not old
        for g, w in zip(got, serve.eager(cams, 0, click, return_mask=True)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_a_sharded_frame_replay_is_the_eager_frame(nccl_group):
    from samnerf_tpu_torch.engine.eval_render import build_sharded_frame_fn
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.perception.sam.sam import Sam, init_decoder_params
    from samnerf_tpu_torch.utils.init import init_state

    dev, size = nccl_group, 64
    cfg = dataclasses.replace(SMALL, hash_q8_serve=True, serve_fuse_mlp=True)
    model = SAMModel(cfg, device=dev)
    model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                     torch.Generator().manual_seed(1), device=dev,
                                     table_scale=0.5))
    sam = Sam(device=dev)
    sam.load_state_dict(init_decoder_params(torch.Generator().manual_seed(2), dev))
    snr = SamNerfRenderer(model, chunk=1024, serve_preset="static")
    snr.bake_serve_tables()
    frame = build_sharded_frame_fn(snr.renderer, size, size, ("sam", "clipseg"), sam=sam)
    grids = build_sharded_frame_fn(snr.renderer, size, size, ("sam", "clipseg"))
    for i, click in enumerate([(20.0, 40.0), (32.0, 32.0), (50.0, 10.0)]):
        cams = _cameras(dev, i, size)
        coords = torch.zeros((1, 4, 2), device=dev)
        coords[0, 0] = torch.tensor(click) * 1024.0 / size
        labels = torch.full((1, 4), -1, dtype=torch.int32, device=dev)
        labels[0, 0] = 1
        for fn, args in ((frame, (coords, labels)), (grids, ())):
            (want, eager), eager_on_card = _on_card(
                lambda: _launched(lambda: fn.eager(cams, 0, *args)),
                lambda out, c: c == out[1])
            assert eager_on_card == eager and eager["FUSED-QMLP"]
            if i == 0:      # the first call runs one eager frame, then captures it
                got, python = _launched(lambda: fn(cams, 0, *args))
                assert python == {k: 2 * n for k, n in eager.items()}
            else:
                (got, python), on_card = _on_card(lambda: _launched(lambda: fn(cams, 0, *args)),
                                                  lambda _, c: c == eager)
                assert not any(python.values()) and on_card == eager
            assert got.keys() == want.keys()
            for k in want:
                assert torch.equal(got[k], want[k]), k
    assert len(frame.graphs) == len(grids.graphs) == 1


SMALL_ENCODER = dict(img_size=256, patch_size=16, embed_dim=160, depth=4, num_heads=2,
                     mlp_ratio=4.0, out_chans=256, window_size=7, global_attn_indexes=(2,),
                     flash_min_tokens=256)


@pytest.mark.cuda
def test_a_predictor_replay_is_the_eager_call():
    from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
    from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
    from samnerf_tpu_torch.perception.sam.sam import Sam
    from samnerf_tpu_torch.utils.init import init_state

    dev = _cuda()
    sam = Sam(ImageEncoderViT(**SMALL_ENCODER, device=dev), device=dev)
    sam.load_state_dict(init_state(Sam(ImageEncoderViT(**SMALL_ENCODER, device="meta"),
                                       device="meta"), torch.Generator().manual_seed(4), dev))
    graphed, eager = SamPredictor(sam), SamPredictor(sam, use_graphs=False)
    rng = np.random.default_rng(0)
    prompts = [dict(point_coords=np.array([[60.0, 80.0]]), point_labels=np.array([1])),
               dict(point_coords=np.array([[60.0, 80.0], [100.0, 40.0], [10.0, 150.0]]),
                    point_labels=np.array([1, 0, 1]), multimask_output=False),
               dict(point_coords=np.array([[70.0, 90.0], [20.0, 30.0]]),
                    point_labels=np.array([1, 1]), box=np.array([10.0, 20.0, 150.0, 170.0])),
               dict(box=np.array([30.0, 10.0, 120.0, 160.0]))]
    first = None
    for i, shape in enumerate([(180, 240, 3), (256, 200, 3), (120, 256, 3)]):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        eager.set_image(img)
        (_, python), on_card = _on_card(
            lambda: _launched(lambda: graphed.set_image(img)),
            None if i == 0 else lambda _, c: c["FLASH-RELPOS"] == 1)
        assert torch.equal(graphed.get_image_embedding(), eager.get_image_embedding())
        if i == 0:      # eager, then captured
            assert python["FLASH-RELPOS"] == 2
            first = (graphed.get_image_embedding(), eager.get_image_embedding())
        else:
            assert not any(python.values()) and on_card["FLASH-RELPOS"] == 1
        for kw in prompts:
            for got, want in zip(graphed.predict(**kw), eager.predict(**kw)):
                np.testing.assert_array_equal(got, want)
        pts = rng.uniform(0, 256, (5, 1, 2)).astype(np.float32)
        for got, want in zip(graphed.predict_batched(pts, np.ones((5, 1), np.int64)),
                             eager.predict_batched(pts, np.ones((5, 1), np.int64))):
            np.testing.assert_array_equal(got, want)
    assert torch.equal(*first) and not torch.equal(first[0], graphed.get_image_embedding())
    assert len(graphed._graphs.graphs) == 1 + len(prompts) + 1
    assert graphed.calls["captured"] == 6 and graphed.calls["replayed"] == 2 * 6


def _zoo_snapshot(zs):
    return (copy.deepcopy(zs.model.state_dict()), copy.deepcopy(zs.optimizer.state_dict()),
            zs.generator.get_state(),
            None if zs.occupancy is None else zs.occupancy.clone())


def _zoo_restore(zs, snap):
    model, opt, gen, grid = snap
    zs.model.load_state_dict(model)
    zs.optimizer.load_state_dict(copy.deepcopy(opt))
    zs.generator.set_state(gen)
    if grid is not None:
        zs.occupancy.copy_(grid)


def _zoo_distance(a, b):
    worst = max(_rel(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"]
    for name, s in sa["optimizer"]["state"].items():
        t = sb["optimizer"]["state"][name]
        worst = max(worst, _rel(s["exp_avg"], t["exp_avg"]),
                    _rel(s["exp_avg_sq"], t["exp_avg_sq"]))
    return worst


ZOO_METHODS = ("vanilla-nerf", "mipnerf", "instant-ngp", "tensorf", "depth-nerfacto",
               "semantic-nerfw", "nerfplayer-nerfacto", "nerfplayer-ngp")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ZOO_METHODS)
def test_a_zoo_chunk_replay_is_its_eager_chunk(name, tmp_path, monkeypatch):
    from samnerf_tpu_torch import train as ttrain

    from torch_zoo_tiny import tiny_configs, write_extras

    dev = _cuda()
    tiny_configs(monkeypatch)
    scene = synthetic.write_scene(tmp_path / "scene", num_train=3, num_test=1, h=32, w=32)
    write_extras(scene, size=32)
    args = ttrain.zoo_arg_parser(name).parse_args(
        ["--data", str(scene), "--rays-per-batch", "256"])
    graphed = ttrain.setup_zoo(name, args, dev)
    chunk = graphed.method.dispatch_chunk
    if graphed.occupancy is not None:
        graphed.update_grid()
    _, python = _launched(graphed.run_chunk)                  # eager, then captured
    snap = _zoo_snapshot(graphed)
    eager = []
    for stream in (None, None, torch.cuda.Stream(dev)):
        zs = ttrain.setup_zoo(name, args, dev)
        _zoo_restore(zs, snap)
        torch.cuda.synchronize()        # the side stream starts from the restored state
        with torch.cuda.stream(stream):
            metrics, launched = _launched(zs.run_chunk.eager)
        torch.cuda.synchronize()
        eager.append((zs, float(metrics["total_loss"]), launched))
    metrics, replay_python = _launched(graphed.run_chunk)
    assert graphed.run_chunk.steps_by_dispatch == {"eager": chunk, "captured": chunk,
                                                   "replayed": chunk}
    (e1, l1, launched), (e2, _, _), (e3, _, _) = eager
    assert python == {k: 2 * v for k, v in launched.items()}
    assert not any(replay_python.values())
    if name in ("instant-ngp", "depth-nerfacto", "semantic-nerfw"):
        assert launched["F32-ENC"] and launched["F32-ENC-BWD"]
    # the eager chunks' spread: the widest of their three pairs; the replay
    # against each of them
    spread = max(_zoo_distance(a, b) for a, b in ((e1, e2), (e1, e3), (e2, e3)))
    gap = max(_zoo_distance(graphed, e) for e in (e1, e2, e3))
    print(f"{name}: chunk replay vs eager chunk {gap:.3e} (three eager chunks {spread:.3e})")
    assert gap <= max(4 * spread, TOL_REL)
    assert abs(float(metrics["total_loss"]) - l1) <= TOL_LOSS * abs(l1)
    # a further replay runs on the card the hash kernels the eager chunk launched
    _, on_card = _on_card(graphed.run_chunk, lambda _, c: c == launched)
    assert on_card == launched
