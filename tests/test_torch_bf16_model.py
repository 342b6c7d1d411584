"""The tiny ``SAMModel`` with ``compute_dtype = bfloat16``: the port
against the JAX package on the CPU, with the same flax weights.

- The eval forward (rgb, depth, accumulation, the SAM and ClipSeg
  feature renders through the bf16 MLPs and conv head).
- One ``samnerf_distill``-shaped train step at proposal gate 1, as
  ``test_torch_train_step.py`` runs it (same batch, camera and jitter):
  the loss dict and every parameter's gradient.  The parameters stay f32
  and so do their gradients; the hash encodes return f32 and their
  cotangents reach F32-ENC-BWD's plain version in f32.

Tolerance (``test_torch_bf16_layers.assert_composite``): per output, loss
and gradient tensor, the port's mean absolute error against JAX's bf16 at
most half of JAX's own bf16-against-f32 one, and its largest within
2^-5 of the largest value.  A loss is one number, so its own error is
held at half of JAX's.

Bias gradients are held against another bf16 reference.  A bias gradient
is the layer's bf16 cotangent summed over the points.  XLA on the CPU
takes that sum with bf16 partial sums; the port sums in f32 and rounds to
bf16 once.  So the reference is JAX's own bf16 cotangent of each
``nn.Dense`` / ``nn.Conv`` output, caught by a flax interceptor, summed
in f32 in numpy and rounded to bf16 once.  The port's bias gradient must
be bf16 values (the rounding happened), within the composite tolerance of
that reference, and no further from JAX's f32 gradient than JAX's bf16
one is.  The share of JAX's own bias-gradient elements that differ from
the reference is printed.

JAX runs op by op here, not under ``jit``: the rounding points the port
mirrors are those of the flax modules' operations; under ``jit`` XLA may
keep bf16 intermediates of a fusion in f32.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.core.cameras import Cameras as JaxCameras, generate_rays as jax_rays
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.engine.trainer import TrainState, loss_and_grads
from samnerf_tpu_torch.models import sam_model as tm

from test_torch_bf16_layers import assert_composite, f32
from test_torch_serve_slice import _model_params, port_config
from test_torch_train_step import C2W, CFG, FEATURES, H, R, W, _batch

CFG_BF16 = dataclasses.replace(CFG, compute_dtype=jnp.bfloat16)


def _jax_cameras():
    return JaxCameras(camera_to_worlds=jnp.asarray(C2W[None]), fx=jnp.asarray([[30.0]]),
                      fy=jnp.asarray([[30.0]]), cx=jnp.asarray([[W / 2.0]]),
                      cy=jnp.asarray([[H / 2.0]]), width=W, height=H)


def _cameras():
    return Cameras(camera_to_worlds=torch.from_numpy(C2W[None]),
                   fx=torch.tensor([[30.0]]), fy=torch.tensor([[30.0]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H)


def _port_model(params):
    cfg = port_config(CFG_BF16)
    assert cfg.compute_dtype == torch.bfloat16
    model = tm.SAMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    assert model.fields.mlp_base.compute_dtype == model.conv.compute_dtype == torch.bfloat16
    return cfg, model


def test_eval_forward_bf16_matches_jax():
    params = _model_params(CFG, seed=5)
    idx = _batch()["indices"]
    outs = {}
    for name, cfg in (("bf16", CFG_BF16), ("f32", CFG)):
        rb = jax_rays(_jax_cameras(), idx[:, 0], idx[:, 1:])
        outs[name] = jm.SAMModel(cfg).apply(params, rb, train=False, get_features=FEATURES)
    _, model = _port_model(params)
    rb = generate_rays(_cameras(), torch.from_numpy(idx[:, 0]).long(),
                       torch.from_numpy(idx[:, 1:]).long())
    ours = model(rb, get_features=FEATURES)
    for key in ("rgb", "depth", "accumulation", "sam", "clipseg"):
        assert ours[key].dtype == torch.float32, key
        assert_composite(ours[key], outs["bf16"][key], outs["f32"][key], f"eval {key}")


def _layer_cotangents(cots):
    """A flax interceptor: each ``nn.Dense`` / ``nn.Conv`` output passes
    through an identity whose backward appends (module path, the output's
    cotangent) to ``cots``."""
    def tap(path):
        @jax.custom_vjp
        def identity(y):
            return y

        def bwd(_, ct):
            jax.debug.callback(lambda c: cots.append((path, np.asarray(c))), ct)
            return (ct,)

        identity.defvjp(lambda y: (y, None), bwd)
        return identity

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and isinstance(context.module,
                                                            (nn.Dense, nn.Conv)):
            return tap(context.module.scope.path)(out)
        return out

    return nn.intercept_methods(interceptor)


def _bias_reference(grads, cots):
    """``grads`` with each caught layer's bias gradient replaced by its
    bf16 cotangent summed over the points in f32 and rounded to bf16 once."""
    paths = [path for path, _ in cots]
    assert len(set(paths)) == len(paths), paths      # each layer runs once
    tree = jax.tree.map(np.array, grads)
    for path, ct in cots:
        assert ct.dtype == jnp.bfloat16, path
        node = tree["params"]
        for key in path:
            node = node[key]
        total = ct.astype(np.float32).reshape(-1, ct.shape[-1]).sum(0)
        node["bias"] = f32(jnp.asarray(total).astype(jnp.bfloat16))
    return tree


@pytest.fixture(scope="module")
def jax_steps():
    """(params, batch, rng, anneal, gate) -> (loss dict, grads, layer
    cotangents), op by op, in bf16 and in f32."""
    def make(cfg):
        model = jm.SAMModel(cfg)

        def step(params, batch, rng, anneal, gate):
            idx = batch["indices"]
            rb = jax_rays(_jax_cameras(), idx[:, 0], idx[:, 1:])
            cots = []

            def loss_fn(p):
                with _layer_cotangents(cots):
                    out = model.apply(p, rb, rng=rng, train=True, anneal=anneal,
                                      proposal_grad=gate, get_features=FEATURES)
                ld = jm.get_loss_dict(cfg, out, batch)
                return sum(ld.values()), ld

            (_, ld), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return ld, grads, cots

        return step

    return {"bf16": make(CFG_BF16), "f32": make(CFG)}


def test_train_step_bf16_matches_jax(jax_steps):
    step, since = 3, 0
    params = _model_params(CFG, seed=5)
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, len(CFG.num_proposal_samples_per_ray) + 1)
    jitter = [np.array(jax.random.uniform(k, (R, 1))) for k in keys]
    cfg, model = _port_model(params)
    anneal = tm.proposal_anneal_value(cfg, step)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    refs = {name: fn(params, jbatch, rng, anneal, 1.0) for name, fn in jax_steps.items()}
    ld, _, gate = loss_and_grads(model, cfg, TrainState(step, since), _cameras(),
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 FEATURES, jitter=[torch.from_numpy(j) for j in jitter])
    assert gate == 1.0
    assert set(ld) == set(refs["bf16"][0])
    for k in ld:
        ours, ref, ref32 = ld[k].item(), float(refs["bf16"][0][k]), float(refs["f32"][0][k])
        print(f"loss {k}: port {ours:.7g} JAX bf16 {ref:.7g} f32 {ref32:.7g}")
        assert np.isfinite(ours) and abs(ours - ref) <= 0.5 * abs(ref - ref32), k
    grads = {name: params_from_jax(jax.tree.map(np.asarray, r[1])) for name, r in refs.items()}
    bias_refs = params_from_jax(_bias_reference(refs["bf16"][1], refs["bf16"][2]))
    n_bias = 0
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        ref, ref32 = grads["bf16"][name].numpy(), grads["f32"][name].numpy()
        if not np.abs(ref32).sum() > 0:
            continue
        if not name.endswith("bias"):
            assert_composite(p.grad, ref, ref32, f"grad {name}")
            continue
        n_bias += 1
        ours, ref_sum = p.grad.numpy(), bias_refs[name].numpy()
        assert not np.array_equal(ref_sum, ref32), name     # the reference is bf16
        print(f"grad {name}: JAX's bias gradient differs from its f32-summed cotangent "
              f"on {np.mean(ref != ref_sum):.1%}, the port's on {np.mean(ours != ref_sum):.1%}")
        np.testing.assert_array_equal(ours, f32(p.grad.bfloat16()), err_msg=name)
        assert_composite(p.grad, ref_sum, ref32, f"grad {name}")
        err, jax_err = np.abs(ours - ref32).mean(), np.abs(ref - ref32).mean()
        print(f"grad {name}: port vs JAX f32 mean {err:.3e}, JAX bf16 vs f32 {jax_err:.3e}")
        assert err <= jax_err, name
    assert n_bias == len(refs["bf16"][2]) == 13
