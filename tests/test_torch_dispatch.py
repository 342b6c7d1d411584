"""``steps_per_dispatch`` in the port against the JAX package and against
the port's own eager step, on the CPU (the CUDA graphs themselves:
``tests/test_torch_cuda_dispatch.py`` on a card).

- A block's per-step values (:func:`trainer.dispatch_scalars`) for steps
  0-1100, in blocks of 20 from step 0 and from a resumed step of 7: the
  proposal anneal and gate equal JAX's ``proposal_anneal_value`` and
  ``proposal_grad_gate`` bit for bit in f32 (``steps_since_update``
  evolved as JAX's ``make_train_step`` evolves it), as the port's eager
  step takes them: JAX's functions evaluated op by op, as in
  ``test_torch_train_step.py`` (under ``jax.jit`` XLA multiplies by 1/1000
  and fuses an FMA, which moves the anneal by one ulp at 318 of these
  steps).  The lrs the block's Adam scalars take (the port's schedule at
  the optimizer's count, in float64) equal optax's f32 schedule within
  1e-6 relative (JAX rounds its exponent's
  argument to f32 and takes XLA's exp: 6-12 ulps from the exact value).
- The tiny model's losses and gradients with the anneal and gate as 0-d
  tensors (a graph's per-step values) equal those with floats bit for
  bit, at anneal < 1 and = 1 and gate 0 and 1.
- JAX's ``Trainer`` and the port's with ``steps_per_dispatch=4`` over 10
  iterations fire callbacks, log rows, eval batches, eval images and
  checkpoints at the same steps.  The steps themselves and the eval
  renders are stubbed in JAX (its loop is what is compared); the port
  trains.  One difference is the port's on purpose: JAX hands the steps
  that do not fill a last block the count that remains (``n = min(block,
  remaining)``) where the port hands the one step it ran, so JAX fires a
  cadence again for a multiple the block before already passed, and at
  the first step of a run shorter than a block it fires every cadence;
  the last two cases hold that difference.
- The tiny trainer's 8 steps in blocks of 4 (``_block_step`` with its
  0-d anneal and gate and ``GroupedAdam.device_step``) against the same 8
  as eager steps, from one seed (no atomics on the CPU, so each run is
  deterministic): the same step and optimizer counts; with the eager step
  updating through ``device_step`` too, the same losses, parameters and
  moments bit for bit; with its own ``torch.optim.Adam``, losses within
  ``TOL_LOSS`` relative and parameters and moments within ``TOL_DRIFT``
  relative L2, the update's rounding carried on by later gradients.
- ``GroupedAdam.device_step`` (the graph's update) against
  ``GroupedAdam.step`` (``torch.optim.Adam``) on the same gradients for 5
  steps: moments and step counts bit for bit, parameters within
  ``2 k eps (|p| + lr)`` after k steps (f32 eps; the step rounds in
  another order), and the state dict loads across the two.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from samnerf_tpu.configs.methods import method_configs as jax_methods
from samnerf_tpu.data.datamanager import (DataManager as JaxDataManager,
                                          DataManagerConfig as JaxDMConfig)
from samnerf_tpu.data.dataparser import DataparserConfig as JaxDPConfig
from samnerf_tpu.engine import optimizers as jax_opt
from samnerf_tpu.engine.trainer import Trainer as JaxTrainer, TrainerConfig as JaxTC
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig
from samnerf_tpu_torch.engine.trainer import (Trainer, TrainerConfig, dispatch_scalars,
                                              loss_and_grads)
from samnerf_tpu_torch.models import sam_model as tm
from samnerf_tpu_torch.utils import synthetic
from samnerf_tpu_torch.utils.init import init_state

from test_torch_serve_slice import port_config
from test_torch_train_slice import GROUPS, TINY as PORT_TINY, _dm_config
from test_torch_train_step import C2W, CFG, FEATURES, H, W, _batch

LAST = 1100
TOL_LOSS = 1e-4                 # relative, as the card's block-against-eager check
# relative L2 of a parameter or moment after 8 steps of the two updates:
# 1.5e-5 at worst for a parameter here, 1.0e-4 for the proposal table's
# first moment (its gradients are the smallest, so the carried rounding
# is largest against them)
TOL_DRIFT = 1e-3


def _preset():
    preset = method_configs()["samnerf_distill"]
    model = tm.SAMModel(preset.model, device="meta")
    return preset.model, GroupedAdam(preset.optimizers, model), preset.optimizers


@pytest.mark.parametrize("start", [0, 7])
def test_block_values_match_jax(start):
    cfg, optimizer, groups = _preset()
    jcfg = jax_methods()["samnerf_distill"].model
    optimizer.count = start
    step, since = start, 0
    anneals, gates, lrs = [], [], []
    while step <= LAST:
        rows, since = dispatch_scalars(cfg, optimizer, step, since, 20)
        anneals += list(rows[:, 0])
        gates += list(rows[:, 1])
        lrs.append([[optimizer.schedules[g](optimizer.count + i) for g in optimizer.names]
                    for i in range(20)])
        step += 20
        optimizer.advance(20)
    steps = np.arange(start, step)
    j_since, j_gates = jnp.asarray(0, jnp.int32), []
    for s in steps:
        g = jm.proposal_grad_gate(jcfg, jnp.asarray(s, jnp.int32), j_since)
        j_gates.append(np.float32(g))
        j_since = jnp.where(g > 0, 0, j_since + 1).astype(jnp.int32)
    j_anneal = np.asarray([np.float32(jm.proposal_anneal_value(jcfg, jnp.asarray(s, jnp.int32)))
                           for s in steps])
    np.testing.assert_array_equal(np.asarray(anneals, np.float32), j_anneal)
    np.testing.assert_array_equal(np.asarray(gates, np.float32), np.asarray(j_gates))
    assert since == int(j_since)
    assert anneals[steps.tolist().index(1000)] == 1.0 > anneals[steps.tolist().index(999)]
    lrs = np.concatenate(lrs)
    for j, name in enumerate(optimizer.names):
        optax = np.asarray(jax.jit(jax.vmap(jax_opt.exponential_decay_schedule(
            jax_opt.OptimizerGroupConfig(**dataclasses.asdict(groups[name])))))(
                jnp.asarray(steps)))
        np.testing.assert_allclose(lrs[:, j], optax, rtol=1e-6, atol=0)


def _cameras():
    return Cameras(camera_to_worlds=torch.from_numpy(C2W[None]),
                   fx=torch.tensor([[30.0]]), fy=torch.tensor([[30.0]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H)


@pytest.mark.parametrize("anneal_step,gate", [(3, 1.0), (3, 0.0), (1200, 1.0), (1200, 0.0)])
def test_tensor_anneal_and_gate_give_the_float_step(anneal_step, gate):
    cfg = port_config(CFG)
    anneal = tm.proposal_anneal_value(cfg, anneal_step)
    assert (anneal == 1.0) == (anneal_step >= cfg.proposal_weights_anneal_max_num_iters)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    jitter = [torch.from_numpy(np.random.default_rng(3).uniform(size=(batch["image"].shape[0], 1))
                               .astype(np.float32)) for _ in range(2)]
    state = init_state(tm.SAMModel(cfg, device="meta"), torch.Generator().manual_seed(5),
                       "cpu", table_scale=0.5)
    out = []
    for scalars in ((anneal, gate), (torch.tensor(anneal), torch.tensor(gate))):
        model = tm.SAMModel(cfg, device="cpu")
        model.load_state_dict(state)
        ld, _, _ = loss_and_grads(model, cfg, None, _cameras(), batch, FEATURES,
                                  jitter=jitter, scalars=scalars)
        out.append(({k: v.detach() for k, v in ld.items()},
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    (ld_f, gr_f), (ld_t, gr_t) = out
    assert ld_f.keys() == ld_t.keys()
    for k in ld_f:
        assert torch.equal(ld_f[k], ld_t[k]), k
    for n in gr_f:
        assert torch.equal(gr_f[n], gr_t[n]), n
    prop = [n for n in gr_f if n.startswith("proposal_networks")]
    assert any(bool(gr_f[n].abs().sum() > 0) for n in prop) == bool(gate)


class _StubPipeline:
    """Records the steps the trainer evaluates at."""

    def __init__(self, events):
        self.events = events

    def get_eval_loss_dict(self, *args):
        self.events["eval_batch"].append(args[1] if len(args) == 3 else args[0])
        return {"rgb_loss": 0.5}

    def get_eval_image_metrics_and_images(self, *args):
        return {"psnr": 10.0, "num_rays": 1}, {}


def _events():
    return {"callback": [], "log": [], "eval_batch": [], "eval_image": [], "save": []}


def _record(trainer, events):
    trainer._pipeline = lambda: _StubPipeline(events)
    trainer.save_checkpoint = lambda step: events["save"].append(step)
    history = trainer.metrics_history

    class History(list):
        def append(self, item):
            step, m = item
            (events["eval_image"] if "num_rays" in m else events["log"]).append(step)
            super().append(item)

    trainer.metrics_history = History(history)
    return lambda step, metrics: events["callback"].append(step)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return synthetic.write_scene(tmp_path_factory.mktemp("scene"), num_train=4, num_test=2,
                                 h=32, w=32, with_features=True, feature_long_side=8)


@pytest.fixture(scope="module")
def jax_trainer(scene, tmp_path_factory):
    """JAX's Trainer with its steps stubbed: the fused block advances the
    state's step by the block, a single step returns metrics."""
    dm = JaxDataManager(JaxDMConfig(
        dataparser=JaxDPConfig(data=scene, train_val_json_split=True),
        train_num_rays_per_batch=256, eval_num_rays_per_batch=256, patch_size=2,
        distill_sam=True, use_clipseg_feature=True), seed=0)
    tcfg = JaxTC(max_num_iterations=10, output_dir=tmp_path_factory.mktemp("jax"),
                 steps_per_dispatch=4)
    jtr = JaxTrainer(dataclasses.replace(CFG, num_images=dm.num_train_images), tcfg,
                     {g: jax_opt.OptimizerGroupConfig(**dataclasses.asdict(c))
                      for g, c in GROUPS.items()}, dm)
    metrics = {"total_loss": jnp.float32(1.0), "psnr": jnp.float32(10.0)}
    jtr._fused_step = lambda state, cams, data, key: (
        state.replace(step=state.step + tcfg.steps_per_dispatch), metrics)
    jtr.train_iteration = lambda step: metrics
    return jtr


def _run_jax(jtr, **cadences):
    jtr.cfg = dataclasses.replace(jtr.cfg, **cadences)
    jtr.state = jtr.state.replace(step=jnp.asarray(0, jnp.int32))
    jtr.metrics_history = []
    events = _events()
    callback = _record(jtr, events)
    jtr.train(step_callback=callback)
    return events


def _run_port(scene, out, **cadences):
    tr = Trainer(PORT_TINY, TrainerConfig(output_dir=out, steps_per_dispatch=4, **cadences),
                 GROUPS, DataManager(_dm_config(scene)), device="cpu")
    events = _events()
    callback = _record(tr, events)
    tr.train(step_callback=callback)
    return events


def test_trainer_cadences_match_jax(scene, jax_trainer, tmp_path):
    cadences = dict(max_num_iterations=10, log_every=3, steps_per_eval_batch=5,
                    steps_per_eval_image=7, steps_per_save=4)
    want = _run_jax(jax_trainer, **cadences)
    got = _run_port(scene, tmp_path, **cadences)
    assert got == want
    assert want["callback"] == [4, 8, 9, 10] and want["save"] == [4, 8, 10]
    assert want["log"] == [4, 8, 9, 10] and want["eval_batch"] == [8, 10]
    assert want["eval_image"] == [8]


@pytest.mark.parametrize("cadences,extra", [
    # a cadence of 2 passes 8 in the block [4, 8); JAX's step 9 counts [7, 9)
    (dict(max_num_iterations=10, log_every=2, steps_per_eval_batch=2,
          steps_per_eval_image=0, steps_per_save=100), {"log": [9], "eval_batch": [9]}),
    # three single steps: JAX's first counts [-2, 1), which holds 0
    (dict(max_num_iterations=3, log_every=5, steps_per_eval_batch=5,
          steps_per_eval_image=5, steps_per_save=100), {"log": [1], "eval_batch": [1],
                                                         "eval_image": [1]}),
])
def test_trainer_fires_once_per_crossing_where_jax_fires_again(scene, jax_trainer, tmp_path,
                                                                cadences, extra):
    want = _run_jax(jax_trainer, **cadences)
    got = _run_port(scene, tmp_path, **cadences)
    for k in want:
        assert sorted(got[k] + extra.get(k, [])) == want[k], k


def _train_tiny(scene, out, n, eager_update):
    """The tiny trainer's 8 steps, ``n`` a dispatch; ``eager_update``
    "device_step": the eager step updates as a block does."""
    tr = Trainer(PORT_TINY, TrainerConfig(output_dir=out, max_num_iterations=8,
                                          steps_per_dispatch=n, steps_per_save=100,
                                          steps_per_eval_batch=0, steps_per_eval_image=0,
                                          save_final=False),
                 GROUPS, DataManager(_dm_config(scene)), device="cpu")
    if eager_update == "device_step":
        opt = tr.optimizer

        def step():
            opt.device_step(torch.from_numpy(opt.block_scalars(1)[0]))
            opt.advance(1)

        opt.step = step
    losses = {}
    tr.train(step_callback=lambda step, m: losses.update(
        {step: {k: float(v) for k, v in m.items()}}))
    return tr, losses


@pytest.mark.parametrize("eager_update", ["device_step", "adam"])
def test_blocks_train_as_eager_steps(scene, tmp_path, eager_update):
    blocks, block_losses = _train_tiny(scene, tmp_path / "b", 4, eager_update)
    eager, eager_losses = _train_tiny(scene, tmp_path / "e", 1, eager_update)
    assert blocks.steps_by_dispatch == {"eager": 8, "captured": 0, "replayed": 0}
    assert blocks.state == eager.state and blocks.state.step == 8
    assert blocks.optimizer.count == eager.optimizer.count == 8
    assert sorted(block_losses) == [4, 8] and sorted(eager_losses) == list(range(1, 9))
    sb, se = blocks.optimizer.state_dict(), eager.optimizer.state_dict()
    pairs = [(p.detach(), q.detach())
             for p, q in zip(blocks.model.parameters(), eager.model.parameters())]
    pairs += [(s[k], se["optimizer"]["state"][i][k])
              for i, s in sb["optimizer"]["state"].items() for k in ("exp_avg", "exp_avg_sq")]
    if eager_update == "device_step":
        # the block's sampling, 0-d anneal and gate and update are the
        # eager step's, bit for bit
        assert all(block_losses[s] == eager_losses[s] for s in block_losses)
        assert all(torch.equal(a, b) for a, b in pairs)
    else:
        # Adam's update rounds in another order (a few ulps a step, the
        # test below), and 8 steps' gradients carry that on (TOL_DRIFT)
        for s, m in block_losses.items():
            for k, v in m.items():
                assert abs(v - eager_losses[s][k]) <= TOL_LOSS * abs(eager_losses[s][k]), (s, k)
        for a, b in pairs:
            assert float((a - b).double().norm()) <= TOL_DRIFT * float(b.double().norm())


def _params():
    torch.manual_seed(0)
    model = nn.Module()
    model.fields = nn.Linear(64, 64)
    model.conv = nn.Linear(64, 3)
    return model


def test_device_step_matches_adam_and_shares_its_state():
    groups = {"fields": OptimizerGroupConfig(lr=1e-2, lr_final=5e-4, max_steps=100),
              "conv": OptimizerGroupConfig(lr=5e-4, lr_final=1e-4, max_steps=100)}
    eager_model, device_model = _params(), _params()
    eager, device = GroupedAdam(groups, eager_model), GroupedAdam(groups, device_model)
    g = torch.Generator().manual_seed(1)
    eps = torch.finfo(torch.float32).eps
    for k in range(1, 6):
        grads = [torch.randn(p.shape, generator=g) * 10.0 ** float(torch.randint(-6, 2, (),
                                                                                 generator=g))
                 for p in eager_model.parameters()]
        for model, opt in ((eager_model, eager), (device_model, device)):
            opt.zero_grad()
            for p, grad in zip(model.parameters(), grads):
                p.grad = grad.clone()
        eager.step()
        device.device_step(torch.from_numpy(device.block_scalars(1)[0]))
        device.advance(1)
        for (name, p), q in zip(eager_model.named_parameters(), device_model.parameters()):
            lr = eager.configs[name.split(".")[0]].lr
            assert bool(((p - q).abs() <= 2 * k * eps * (p.abs() + lr)).all()), (k, name)
    se, sd = eager.state_dict(), device.state_dict()
    assert se["count"] == sd["count"] == 5
    for name, s in se["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key], sd["optimizer"]["state"][name][key]), (name, key)
    assert all(s["step"].device.type == "cpu" for s in sd["optimizer"]["state"].values())
    # each path resumes from the other's state dict as from its own
    for src_model, src, via in ((eager_model, eager, "device"), (device_model, device, "eager")):
        runs = []
        for state in (src.state_dict(), copy.deepcopy(src.state_dict())):
            model = copy.deepcopy(src_model)
            opt = GroupedAdam(groups, model)
            opt.load_state_dict(state)
            for p in model.parameters():
                p.grad = torch.ones_like(p)
            if via == "device":
                opt.device_step(torch.from_numpy(opt.block_scalars(1)[0]))
                opt.advance(1)
            else:
                opt.step()
            runs.append((model, opt))
        (m1, o1), (m2, o2) = runs
        assert o1.count == o2.count == 6
        assert all(torch.equal(p, q) for p, q in zip(m1.parameters(), m2.parameters()))
