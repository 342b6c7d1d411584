"""One ``samnerf_distill``-shaped train step of the tiny model in the port
against the JAX package, on the CPU: the same flax weights, batch, camera
and stratified jitter, at proposal gate 1 (step 3, anneal 0.03) and
gate 0 (step 6000, anneal 1).

JAX draws its jitter from ``jax.random.split(rng, 2)`` and
``uniform(keys[i], (R, 1))`` (``samplers.py:74,130``); the test draws the
same numbers there and hands them to the port.  Compared against
``jax.value_and_grad`` of the JAX loss:

- the loss dict, rtol 1e-4 (float32 sums in another order);
- the dense gradients (MLPs, conv head), rtol 1e-3 / atol 1e-5;
- the hash-table gradients, rtol 1e-2 / atol 1e-4 (both round the
  accumulated gradient to bf16, from sums taken in another order).

A ReLU whose input lies within float noise of 0 may open in one package
and not the other; in the conv head, whose weight gradient sums only a
few terms, that moves a gradient beyond the tolerance.  The weights
(seed 5) and batch are chosen so that no conv pre-activation comes within
1e-6 of 0, and the test checks that margin.  The optimizer is held
against optax on identical gradients in ``test_torch_optimizers.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.core.cameras import Cameras as JaxCameras, generate_rays as jax_rays
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.data.device_data import (indices_from_uniform, patch_centers,
                                                uniform_shape)
from samnerf_tpu_torch.engine.trainer import TrainState, loss_and_grads
from samnerf_tpu_torch.models import sam_model as tm

from test_model import TINY
from test_torch_serve_slice import _model_params

H = W = 32
R = 64
C2W = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.6]], np.float32)
CFG = dataclasses.replace(TINY, hash_fn="morton")
FEATURES = ("sam", "clipseg")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random(uniform_shape(R, CFG.patch_size)))
    indices = indices_from_uniform(u, 1, H, W, CFG.patch_size).numpy().astype(np.int32)
    sam = rng.normal(size=(R // 4, 256)).astype(np.float32)
    sam[1] = np.nan                              # a patch without a SAM target
    clipseg = rng.normal(size=(R, 192)).astype(np.float32)
    clipseg[[3, 40]] = np.nan
    return {"indices": indices, "image": rng.uniform(size=(R, 3)).astype(np.float32),
            "sam": sam, "clipseg": clipseg}


@pytest.fixture(scope="module")
def jax_step():
    """Jitted (params, indices, batch, rng, anneal, gate) -> (loss dict, grads)."""
    model = jm.SAMModel(CFG)
    cams = JaxCameras(camera_to_worlds=jnp.asarray(C2W[None]), fx=jnp.asarray([[30.0]]),
                      fy=jnp.asarray([[30.0]]), cx=jnp.asarray([[W / 2.0]]),
                      cy=jnp.asarray([[H / 2.0]]), width=W, height=H)

    @jax.jit
    def step(params, batch, rng, anneal, gate):
        idx = batch["indices"]
        rb = jax_rays(cams, idx[:, 0], idx[:, 1:])

        def loss_fn(p):
            out = model.apply(p, rb, rng=rng, train=True, anneal=anneal,
                              proposal_grad=gate, get_features=FEATURES)
            ld = jm.get_loss_dict(CFG, out, batch)
            return sum(ld.values()), ld

        (_, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return ld, grads

    return step


@pytest.mark.parametrize("step,since,gate", [(3, 0, 1.0), (6000, 1, 0.0)])
def test_train_step_matches_jax(jax_step, step, since, gate):
    params = _model_params(CFG, seed=5)
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, len(CFG.num_proposal_samples_per_ray) + 1)
    jitter = [np.array(jax.random.uniform(k, (R, 1))) for k in keys]

    tcfg = tm.SAMModelConfig(**{f.name: getattr(CFG, f.name)
                                for f in dataclasses.fields(tm.SAMModelConfig)})
    anneal = tm.proposal_anneal_value(tcfg, step)
    assert anneal == float(jm.proposal_anneal_value(CFG, jnp.asarray(step)))
    assert tm.proposal_grad_gate(tcfg, step, since) == gate == float(
        jm.proposal_grad_gate(CFG, jnp.asarray(step), jnp.asarray(since)))
    ref_ld, ref_grads = jax_step(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                 rng, anneal, gate)

    model = tm.SAMModel(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    cams = Cameras(camera_to_worlds=torch.from_numpy(C2W[None]),
                   fx=torch.tensor([[30.0]]), fy=torch.tensor([[30.0]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    margin = []
    model.conv.convs[0].register_forward_hook(
        lambda m, i, o: margin.append(o.detach().abs().min().item()))
    ld, total, g = loss_and_grads(model, tcfg, TrainState(step, since), cams, tbatch,
                                  FEATURES, jitter=[torch.from_numpy(j) for j in jitter])
    assert margin[0] > 1e-6
    assert g == gate
    assert set(ld) == set(ref_ld) == {"rgb_loss", "interlevel_loss", "distortion_loss",
                                      "sam_loss", "clipseg_loss"}
    for k in ld:
        np.testing.assert_allclose(ld[k].item(), float(ref_ld[k]), rtol=1e-4, err_msg=k)

    ref = params_from_jax(jax.tree.map(np.asarray, ref_grads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        assert p.grad is not None, name                  # zeros, never None
        tol = (dict(rtol=1e-2, atol=1e-4) if name.endswith("table")
               else dict(rtol=1e-3, atol=1e-5))
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), err_msg=name, **tol)
    prop = [p.grad for n, p in named.items() if n.startswith("proposal_networks")]
    assert all((gr.abs().sum() > 0) == (gate > 0) for gr in prop)
    assert named["fields.encoding.table"].grad.abs().sum() > 0
    assert named["sam_field.sam_enc.0.table"].grad.abs().sum() > 0


def test_patch_centers_pick_the_middle_pixel():
    u = torch.from_numpy(np.random.default_rng(0).random(uniform_shape(32, 4)))
    idx = indices_from_uniform(u, 3, 20, 20, 4)
    centers = patch_centers(idx, 4)
    np.testing.assert_array_equal(centers, idx.reshape(-1, 4, 4, 3)[:, 2, 2])
    assert (idx.reshape(-1, 4, 4, 3)[:, 2, 2, 1:] == idx.reshape(-1, 4, 4, 3)[:, 0, 0, 1:]
            + 2).all()
