"""The port's per-group Adam and schedule against optax, on the CPU.

Updates are compared on identical gradients, never parameters after a
train step: with eps 1e-15 Adam's first update is about lr * sign(g), so
a gradient of 1e-20 in one package and 0 in the other would move a
parameter by lr.  Tolerance rtol 1e-5 (the port's schedule is float64 on
the host, optax's float32).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch import nn

from samnerf_tpu.engine import optimizers as jo
from samnerf_tpu_torch.engine import optimizers as to

GROUP_ARGS = [dict(lr=1e-2, lr_final=5e-4, max_steps=100),
              dict(lr=5e-4, lr_final=1e-4, max_steps=100, warmup_steps=10),
              dict(lr=1e-3, lr_final=1e-5, max_steps=50, warmup_steps=20, ramp="linear"),
              dict(lr=3e-3, max_steps=10)]


@pytest.mark.parametrize("args", GROUP_ARGS)
def test_schedule_matches_jax(args):
    jsched = jo.exponential_decay_schedule(jo.OptimizerGroupConfig(**args))
    tsched = to.exponential_decay_schedule(to.OptimizerGroupConfig(**args))
    for step in (0, 1, 5, 9, 10, 11, 25, 49, 50, 99, 100, 1000):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-5)


class _Tiny(nn.Module):
    """Top-level prefixes as the model's: fields, proposal_networks.i, conv."""

    def __init__(self):
        super().__init__()
        self.fields = nn.Linear(3, 4)
        self.proposal_networks = nn.ModuleList([nn.Linear(2, 2)])
        self.conv = nn.Linear(2, 3)


def test_three_steps_match_optax():
    """Three updates on the same gradients; the proposal group gets a
    zero gradient at step 1, and ``conv`` is clipped to norm 0.5.  The
    parameters start at 0, so an update is the difference of two floats
    of its own size and loses no digits."""
    groups = {"fields": dict(lr=1e-2, lr_final=5e-4, max_steps=3),
              "proposal_networks": dict(lr=1e-2, lr_final=5e-4, max_steps=3),
              "conv": dict(lr=5e-4, lr_final=1e-4, max_steps=3, max_norm=0.5)}
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    params = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    tree = {}
    for name, v in params.items():
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[name.split(".")[-1]] = jnp.asarray(v)
    jtx = jo.build_optimizer({k: jo.OptimizerGroupConfig(**a) for k, a in groups.items()},
                             {"params": {"fields": tree["fields"],
                                         "proposal_networks_0": tree["proposal_networks"]["0"],
                                         "conv": tree["conv"]}})
    jparams = {"params": {"fields": tree["fields"],
                          "proposal_networks_0": tree["proposal_networks"]["0"],
                          "conv": tree["conv"]}}
    jstate = jtx.init(jparams)
    opt = to.build_optimizer({k: to.OptimizerGroupConfig(**a) for k, a in groups.items()},
                             model)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        if step == 1:
            for k in grads:
                if k.startswith("proposal_networks"):
                    grads[k][:] = 0.0
        jgrads = {"params": {"fields": {n: jnp.asarray(grads[f"fields.{n}"])
                                        for n in ("weight", "bias")},
                             "proposal_networks_0": {
                                 n: jnp.asarray(grads[f"proposal_networks.0.{n}"])
                                 for n in ("weight", "bias")},
                             "conv": {n: jnp.asarray(grads[f"conv.{n}"])
                                      for n in ("weight", "bias")}}}
        updates, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        opt.zero_grad()
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        opt.step()
        for name, p in model.named_parameters():
            top, rest = name.split(".", 1)
            if top == "proposal_networks":
                top, rest = "proposal_networks_0", rest.split(".", 1)[1]
            ref = np.asarray(updates["params"][top][rest])
            np.testing.assert_allclose((p.detach() - before[name]).numpy(), ref,
                                       rtol=1e-5, atol=1e-9, err_msg=f"{step} {name}")
    # the zero-gradient step still moved the proposal group, as optax does
    assert opt.count == 3


def test_missing_group_and_missing_gradient_raise():
    model = _Tiny()
    with pytest.raises(ValueError):
        to.build_optimizer({"fields": to.OptimizerGroupConfig()}, model)
    opt = to.build_optimizer({k: to.OptimizerGroupConfig() for k in
                              ("fields", "proposal_networks", "conv")}, model)
    with pytest.raises(RuntimeError):
        opt.step()                                   # no .grad anywhere
    assert to.group_of("proposal_networks.0.mlp.layers.0.weight") == "proposal_networks"
    assert math.isclose(to.exponential_decay_schedule(to.OptimizerGroupConfig(lr=1e-3))(7),
                        1e-3)
