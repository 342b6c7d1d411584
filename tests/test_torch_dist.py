"""Data parallelism of the port over ``torch.distributed`` (gloo, 2 ranks
spawned on the CPU) against one rank and against the JAX package.

- One train step of the tiny model (``test_torch_train_step.py``'s
  weights, camera, rays and targets, some of them NaN: each rank divides
  its masked feature losses by the group's count of valid targets over
  the world size, so that the ranks' mean is the global masked mean):
  each rank takes its contiguous half of
  the global batch and of JAX's jitter draws (whole 2x2 patches) and the
  gradients are averaged.  Losses against one rank at rtol 1e-5 and against
  JAX's step at rtol 1e-4; gradients against one rank's at the
  train-step tolerances (hash tables rtol 1e-2 / atol 1e-4: each rank
  rounds its partial table gradient to bf16; dense rtol 1e-3 / atol 1e-5;
  one rank's against ``jax.value_and_grad`` is
  ``test_torch_train_step.py``'s); the ranks' new parameters bit for bit
  equal, and against one rank's and JAX's new parameters by the criterion
  of ``tests/test_dp_equivalence.py`` (every element within 2 lr, all but
  1e-5 of them within 3e-4: Adam's first step is about lr * sign(g)).
- A batch that the ranks do not divide raises ValueError.

The Trainer over 2 ranks is ``test_torch_dist_trainer.py``'s, the sharded
frame ``test_torch_dist_frame.py``'s.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.core.cameras import Cameras as JaxCameras
from samnerf_tpu.engine.optimizers import OptimizerGroupConfig as JaxGroup
from samnerf_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from samnerf_tpu.engine.trainer import TrainState as JaxState
from samnerf_tpu.engine.trainer import make_train_step as jax_make_train_step
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.engine.trainer import shard_step_inputs
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.parallel import mesh

import torch_dist_workers as workers
from test_torch_serve_slice import _model_params, port_config
from test_torch_train_step import C2W, CFG, FEATURES, H, R, W, _batch

GROUPS = ("proposal_networks", "fields", "sam_field", "conv")
LR = 1e-2                                       # OptimizerGroupConfig's default


def _cameras():
    return {"camera_to_worlds": C2W[None], "fx": np.array([[30.0]], np.float32),
            "fy": np.array([[30.0]], np.float32), "cx": np.array([[W / 2.0]], np.float32),
            "cy": np.array([[H / 2.0]], np.float32)}


def _close_params(a, b):
    """tests/test_dp_equivalence.py's criterion after one Adam step."""
    total = loose = 0
    for name in a:
        d = np.abs(a[name] - b[name])
        assert d.max() <= 2 * LR, (name, d.max())
        loose += int((d > 3e-4).sum())
        total += d.size
    assert loose / total < 1e-5, (loose, total)


def _close_grads(grads, ref):
    assert set(grads) == set(ref)
    for name, g in grads.items():
        tol = (dict(rtol=1e-2, atol=1e-4) if name.endswith("table")
               else dict(rtol=1e-3, atol=1e-5))
        np.testing.assert_allclose(g, ref[name], err_msg=name, **tol)


@pytest.fixture(scope="module")
def step_case():
    params = _model_params(CFG, seed=5)
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, len(CFG.num_proposal_samples_per_ray) + 1)
    jitter = [np.array(jax.random.uniform(k, (R, 1))) for k in keys]
    payload = {"cfg": port_config(CFG), "params": {k: v.numpy() for k, v in
                                                  params_from_jax(params).items()},
               "groups": GROUPS, "features": FEATURES, "batch": batch, "jitter": jitter,
               "state": (3, 0), "cameras": _cameras(), "size": {"width": W, "height": H}}
    return params, batch, rng, payload


def _jax_step(params, batch, rng):
    """JAX's train step: (new params, metrics)."""
    model = jm.SAMModel(CFG)
    cams = JaxCameras(**{k: jnp.asarray(v) for k, v in _cameras().items()}, width=W,
                      height=H)
    optimizer = jax_build_optimizer({g: JaxGroup() for g in GROUPS}, params)
    state = JaxState(params=params, opt_state=optimizer.init(params),
                     step=jnp.asarray(3, jnp.int32), steps_since_update=jnp.asarray(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_make_train_step(model, CFG, optimizer, FEATURES))
    new_state, metrics = step(state, cams, jbatch, rng)
    new = params_from_jax(jax.tree.map(np.asarray, new_state.params))
    return {k: v.numpy() for k, v in new.items()}, {k: float(v) for k, v in metrics.items()}


def test_train_step_two_ranks_match_one_rank_and_jax(step_case):
    params, batch, rng, payload = step_case
    two = workers.run_ranks("train_step", payload)
    one = workers.train_step(payload)                   # no process group: one rank
    for k in two[0]["params"]:
        np.testing.assert_array_equal(two[0]["params"][k], two[1]["params"][k], err_msg=k)
    jparams, jmetrics = _jax_step(params, batch, rng)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(two[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(two[0]["metrics"][k], jmetrics[k], rtol=1e-4, err_msg=k)
    _close_grads(two[0]["grads"], one["grads"])
    _close_params(two[0]["params"], one["params"])
    _close_params(two[0]["params"], jparams)


def test_shard_step_inputs_split_the_global_draws():
    model = SAMModel(port_config(CFG), device="meta")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    parts = [shard_step_inputs(model, batch, torch.Generator().manual_seed(3), r, 2)
             for r in range(2)]
    jitter = model.draw_jitter(R, torch.Generator().manual_seed(3), "cpu")
    for k, v in batch.items():
        assert parts[0][0][k].shape[0] == v.shape[0] // 2
        np.testing.assert_array_equal(torch.cat([p[0][k] for p in parts]), v)
    for i, j in enumerate(jitter):
        np.testing.assert_array_equal(torch.cat([p[1][i] for p in parts]), j)
    # whole patches: each rank's rays are its patches' rays, patch-major
    idx = parts[1][0]["indices"].reshape(-1, 4, 3)
    assert (idx[:, :, 0] == idx[:, :1, 0]).all()
    with pytest.raises(ValueError):
        shard_step_inputs(model, batch, torch.Generator().manual_seed(3), 0, 3)
    with pytest.raises(ValueError):
        mesh.shard(torch.zeros(10), 0, 4)
