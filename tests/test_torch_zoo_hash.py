"""The model zoo's hash-kernel models in the port against the JAX package,
on the CPU: instant-NGP (with its occupancy grid and random background),
depth-nerfacto (DS-NeRF and URF depth losses) and semantic-NeRF-W, at the
L=4 / 4-step table shapes of ``tests/test_hash_pallas.py`` and the tiny
nerfacto of ``tests/test_model_zoo.py``.

The harness and tolerances are ``test_torch_zoo_fields``'s; the parity
hash tables take rtol 1e-2 / atol 1e-4 (both packages round the
accumulated gradient to bf16, from sums in another order), and the JAX
parity encode runs its plain reference on the CPU, as its own tests do.
JAX draws these models' jitter from the step key: instant-NGP one (R, 1)
draw and the background ``uniform(fold_in(rng, 7), (R, 3))``; the
nerfacto backbone one (R, 1) draw per level from ``split(rng, levels)``.
The test hands the port the same numbers.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.configs import zoo as jzoo
from samnerf_tpu_torch.convert import zoo_params_from_jax

from test_torch_zoo_fields import (R, check_eval, check_step, draw_params, jax_eval,
                                   jax_loss_grads, make_batch, occupancy_pair)

torch.set_num_threads(1)

BASE = dict(distill_sam=False, num_levels=4, max_res=64, log2_hashmap_size=12,
            num_proposal_samples_per_ray=(8,), num_nerf_samples_per_ray=8,
            proposal_net_args=({"hidden_dim": 8, "log2_hashmap_size": 10,
                                "num_levels": 2, "max_res": 32},))


def _uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def test_instant_ngp_matches_jax():
    from samnerf_tpu.models import instant_ngp as jn
    from samnerf_tpu_torch.models import instant_ngp as tn
    kw = dict(num_samples=16, num_levels=4, max_res=64, log2_hashmap_size=12,
              grid_resolution=8)
    jm = jn.InstantNGPModel(jn.InstantNGPConfig(**kw))
    tm = tn.InstantNGPModel(tn.InstantNGPConfig(**kw), device="cpu")
    assert tm.field.encoding.num_steps == 4
    params = draw_params(jm, 11)
    tm.load_state_dict(zoo_params_from_jax("instant-ngp", params))
    grid = occupancy_pair(jm, params, tm, aabb=np.array([[-1.0] * 3, [1.0] * 3],
                                                        np.float32))
    idx, ref = jax_eval(jm, params, jnp.asarray(grid), use_occupancy=True)
    check_eval(tm, idx, ref, {"occupancy": torch.from_numpy(grid)})

    rng = jax.random.PRNGKey(111)
    batch = make_batch(11)
    method = jzoo.zoo_methods()["instant-ngp"]
    ld, grads = jax_loss_grads(method, jm, jm.config, params, batch, rng, jnp.asarray(grid))
    draws = {"jitter": (_uniform(rng, (R, 1)),),
             "bg_rgb": _uniform(jax.random.fold_in(rng, 7), (R, 3))}
    check_step("instant-ngp", tm, tm.config, params, ld, grads, batch, draws, method.lr,
               torch.from_numpy(grid))


def _nerfacto_draws(rng, levels):
    return {"jitter": [_uniform(k, (R, 1)) for k in jax.random.split(rng, levels)]}


@pytest.mark.parametrize("loss_type", ["ds_nerf", "urf"])
def test_depth_nerfacto_matches_jax(loss_type):
    from samnerf_tpu.models import depth_nerfacto as jd
    from samnerf_tpu.models.sam_model import SAMModelConfig as JaxBase
    from samnerf_tpu_torch.models import depth_nerfacto as td
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig as PortBase
    jcfg = jd.DepthNerfactoConfig(depth_loss_type=loss_type, base=JaxBase(**BASE))
    tcfg = td.DepthNerfactoConfig(depth_loss_type=loss_type, base=PortBase(**BASE))
    jm, tm = jd.DepthNerfactoModel(jcfg.base), td.DepthNerfactoModel(tcfg.base, device="cpu")
    params = draw_params(jm, 12)
    tm.load_state_dict(zoo_params_from_jax("depth-nerfacto", params))
    idx, ref = jax_eval(jm, params)
    check_eval(tm, idx, ref)

    rng = jax.random.PRNGKey(112)
    batch = make_batch(12)
    method = jzoo.zoo_methods()["depth-nerfacto"]
    ld, grads = jax_loss_grads(method, jm, jcfg, params, batch, rng)
    assert "depth_loss" in ld
    check_step("depth-nerfacto", tm, tcfg, params, ld, grads, batch,
               _nerfacto_draws(rng, 2), method.lr)


def test_semantic_nerfw_matches_jax():
    from samnerf_tpu.models import semantic_nerfw as js
    from samnerf_tpu.models.sam_model import SAMModelConfig as JaxBase
    from samnerf_tpu_torch.models import semantic_nerfw as ts
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig as PortBase
    jcfg = js.SemanticNerfWConfig(num_classes=5, base=JaxBase(**BASE))
    tcfg = ts.SemanticNerfWConfig(num_classes=5, base=PortBase(**BASE))
    jm, tm = js.SemanticNerfWModel(jcfg), ts.SemanticNerfWModel(tcfg, device="cpu")
    params = draw_params(jm, 13)
    tm.load_state_dict(zoo_params_from_jax("semantic-nerfw", params))
    idx, ref = jax_eval(jm, params)
    check_eval(tm, idx, ref)

    rng = jax.random.PRNGKey(113)
    batch = make_batch(13, num_classes=5)
    method = jzoo.zoo_methods()["semantic-nerfw"]
    ld, grads = jax_loss_grads(method, jm, jcfg, params, batch, rng)
    assert "semantics_loss" in ld
    check_step("semantic-nerfw", tm, tcfg, params, ld, grads, batch,
               _nerfacto_draws(rng, 2), method.lr)
