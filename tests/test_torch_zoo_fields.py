"""The model zoo's non-hash-kernel models in the port against the JAX
package, on the CPU: vanilla-NeRF, mip-NeRF, TensoRF, nerfplayer-nerfacto
and nerfplayer-ngp at the tiny sizes of ``tests/test_model_zoo.py``.

For each model, the same flax weights (drawn with numpy, carried over by
``convert.zoo_params_from_jax``) render a 32-ray batch of one 16x16
camera in eval mode and take one zoo train step.  JAX draws the sampler
jitter from the step's key (``uniform(rng, (R, 1))``, one draw that every
level of these models reuses); the test draws the same numbers and hands
them to the port.  Held against JAX:

- eval ``rgb``, ``accumulation``, ``depth``: rtol 1e-4 / atol 1e-5 (f32
  sums in another order through the MLPs and the compositing);
- the loss dict: rtol 1e-4;
- the gradients: dense rtol 1e-3 / atol 1e-5; the flat hash table rtol
  1e-2 / atol 1e-4 (the port adds contributions with ``index_add_``, JAX
  takes differences of one prefix sum over all of them);
- the parameters after the step's Adam update (optax ``adam(lr)`` applied
  to JAX's gradients): atol 1e-6 where JAX's gradient is at least 1e-4.
  Adam's first update is lr * g / (|g| + 1e-8); a gradient within float
  noise of 0 may take either sign in the two packages, so the entries
  below that are left out.

nerfplayer-ngp also builds its occupancy grid in both packages from the
same random cells and jitter (``update_occupancy``), which must agree
bit for bit, and renders and trains with it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from samnerf_tpu.configs import zoo as jzoo
from samnerf_tpu.core.cameras import Cameras as JaxCameras, generate_rays as jax_rays
from samnerf_tpu.ops import occupancy as jocc
from samnerf_tpu_torch.configs import zoo as tzoo
from samnerf_tpu_torch.convert import zoo_params_from_jax
from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.ops import occupancy as tocc

torch.set_num_threads(1)

H = W = 16
R = 32
FOCAL = 20.0
C2W = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.6]], np.float32)
TOL_EVAL = dict(rtol=1e-4, atol=1e-5)
TOL_DENSE = dict(rtol=1e-3, atol=1e-5)
TOL_TABLE = dict(rtol=1e-2, atol=1e-4)
ADAM_MIN_GRAD = 1e-4
OCC_RES, OCC_SAMPLES = 8, 1024


def jax_cameras():
    return JaxCameras(camera_to_worlds=jnp.asarray(C2W[None]), fx=jnp.asarray([[FOCAL]]),
                      fy=jnp.asarray([[FOCAL]]), cx=jnp.asarray([[W / 2.0]]),
                      cy=jnp.asarray([[H / 2.0]]), width=W, height=H)


def port_cameras():
    return Cameras(camera_to_worlds=torch.from_numpy(C2W[None]),
                   fx=torch.tensor([[FOCAL]]), fy=torch.tensor([[FOCAL]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H)


def make_batch(seed=0, num_classes=0):
    """indices [R, 3] of one image, rgb targets, a depth per ray (two rays
    without one) and class ids."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.zeros(R), rng.integers(0, H, R), rng.integers(0, W, R)], -1)
    depth = rng.uniform(0.2, 1.2, (R, 1)).astype(np.float32)
    depth[[3, 17]] = 0.0
    batch = {"indices": idx.astype(np.int32),
             "image": rng.uniform(size=(R, 3)).astype(np.float32),
             "depth_image": depth}
    if num_classes:
        batch["semantics"] = rng.integers(0, num_classes, (R, 1)).astype(np.int32)
    return batch


def draw_params(model, seed, bundle_kw=None):
    """Flax params of ``model`` drawn with numpy: hash tables U(-0.5, 0.5),
    TensoRF factors N(0, 0.1^2) + 0.05 (so some density is positive), dense
    kernels N(0, 1/fan_in), biases N(0, 0.1)."""
    rb = jax_rays(jax_cameras(), jnp.zeros((R,), jnp.int32), jnp.zeros((R, 2)))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(key, rb, rng=key, train=True,
                                               **(bundle_kw or {})))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "table" in name:
            return rng.uniform(-0.5, 0.5, s.shape).astype(np.float32)
        if "planes" in name or "lines" in name:
            return (rng.normal(0.0, 0.1, s.shape) + 0.05).astype(np.float32)
        if "bias" in name:
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0.0, 1.0, s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_loss_grads(method, model, cfg, params, batch, rng, occupancy=None):
    cams = jax_cameras()

    @jax.jit
    def run(params, batch, rng, occupancy):
        idx = batch["indices"]
        bundle = jax_rays(cams, idx[:, 0], idx[:, 1:].astype(jnp.float32))
        kw = {"occupancy": occupancy} if method.use_occupancy else {}

        def loss_fn(p):
            out = model.apply(p, bundle, rng=rng, train=True, **kw)
            if method.loss_needs_config and method.loss_needs_params:
                losses = method.loss_fn(cfg, p, out, batch)
            elif method.loss_needs_config:
                losses = method.loss_fn(cfg, out, batch)
            else:
                losses = method.loss_fn(out, batch)
            return sum(jax.tree.leaves(losses)), losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return losses, grads

    return run(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, occupancy)


def jax_eval(model, params, occupancy=None, use_occupancy=False):
    idx = make_batch(1)["indices"]
    bundle = jax_rays(jax_cameras(), jnp.asarray(idx[:, 0]),
                      jnp.asarray(idx[:, 1:], jnp.float32))
    kw = {"occupancy": occupancy} if use_occupancy else {}
    out = jax.jit(lambda p, b: model.apply(p, b, train=False, **kw))(params, bundle)
    return idx, {k: np.asarray(out[k]) for k in ("rgb", "accumulation", "depth")}


def check_eval(port_model, idx, ref, kw=None):
    ti = torch.from_numpy(idx).long()
    bundle = generate_rays(port_cameras(), ti[:, 0], ti[:, 1:])
    out = port_model(bundle, train=False, **(kw or {}))
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], err_msg=k, **TOL_EVAL)
    assert np.isfinite(out["rgb"].numpy()).all()


def check_step(name, port_model, port_cfg, jax_params, ld_ref, grads_ref, batch, draws,
               lr, occupancy=None, table_leaves=("table",)):
    """One port zoo step with ``draws``: its losses against ``ld_ref``, the
    gradients against ``grads_ref``, the updated parameters against
    optax's Adam on ``grads_ref``."""
    method = tzoo.zoo_methods()[name]
    opt = tzoo.zoo_optimizer(port_model, lr)
    step = tzoo.make_zoo_train_step(method, port_model, port_cfg, opt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = step(port_cameras(), tbatch, None, occupancy, draws)
    assert set(metrics) - {"total_loss"} == set(ld_ref)
    for k, v in ld_ref.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)

    ref_g = zoo_params_from_jax(name, jax.tree.map(np.asarray, grads_ref))
    named = dict(port_model.named_parameters())
    assert set(named) == set(ref_g)
    for n, p in named.items():
        tol = TOL_TABLE if n.rsplit(".", 1)[-1] in table_leaves else TOL_DENSE
        np.testing.assert_allclose(p.grad.numpy(), ref_g[n].numpy(), err_msg=n, **tol)
    assert sum(float(p.grad.abs().sum()) for p in named.values()) > 0

    adam = optax.adam(lr)
    updates, _ = adam.update(grads_ref, adam.init(jax_params), jax_params)
    new_ref = zoo_params_from_jax(name, jax.tree.map(
        np.asarray, optax.apply_updates(jax_params, updates)))
    for n, p in named.items():
        mask = np.abs(ref_g[n].numpy()) >= ADAM_MIN_GRAD
        np.testing.assert_allclose(p.detach().numpy()[mask], new_ref[n].numpy()[mask],
                                   atol=1e-6, rtol=0, err_msg=n)


def jitter_draws(rng, levels):
    """JAX's one (R, 1) draw from the step key, for every sampling level."""
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (R, 1))))
    return {"jitter": tuple(u for _ in range(levels))}


def build_pair(name, jmod, tmod, cfg_name, model_name, **cfg_kw):
    jcfg = getattr(jmod, cfg_name)(**cfg_kw)
    tcfg = getattr(tmod, cfg_name)(**cfg_kw)
    return getattr(jmod, model_name)(jcfg), jcfg, getattr(tmod, model_name)(tcfg, device="cpu"), tcfg


def run_case(name, jmod, tmod, cfg_name, model_name, cfg_kw, seed, levels,
             occupancy=False):
    jm, jcfg, tm, tcfg = build_pair(name, jmod, tmod, cfg_name, model_name, **cfg_kw)
    params = draw_params(jm, seed)
    tm.load_state_dict(zoo_params_from_jax(name, params))
    jmethod = jzoo.zoo_methods()[name]
    grid = None
    if occupancy:
        grid = occupancy_pair(jm, params, tm, aabb=np.array([[-1.0] * 3, [1.0] * 3],
                                                            np.float32))
    idx, ref = jax_eval(jm, params, None if grid is None else jnp.asarray(grid),
                        jmethod.use_occupancy)
    kw = {"occupancy": torch.from_numpy(grid)} if jmethod.use_occupancy else {}
    check_eval(tm, idx, ref, kw)

    rng = jax.random.PRNGKey(seed + 100)
    batch = make_batch(seed)
    ld, grads = jax_loss_grads(jmethod, jm, jcfg, params, batch, rng,
                               None if grid is None else jnp.asarray(grid))
    check_step(name, tm, tcfg, params, ld, grads, batch, jitter_draws(rng, levels),
               jmethod.lr, None if grid is None else torch.from_numpy(grid))


def occupancy_pair(jm, params, tm, aabb):
    """The grid of one ``update_occupancy`` round in both packages from the
    same cells and jitter (JAX's draws): equal bit for bit; returns it."""
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    cells = OCC_RES ** 3
    gd0 = np.random.default_rng(3).uniform(0.0, 0.02, cells).astype(np.float32)
    jgd, jgrid = jax.jit(lambda gd, k: jocc.update_occupancy(
        gd, lambda p: jm.apply(params, p, method=jm.density_fn), jnp.asarray(aabb), k,
        num_samples=OCC_SAMPLES))(jnp.asarray(gd0), key)
    idx = torch.from_numpy(np.array(jax.random.randint(k1, (OCC_SAMPLES,), 0, cells)))
    jit = torch.from_numpy(np.array(jax.random.uniform(k2, (OCC_SAMPLES, 3))))
    tgd, tgrid = tocc.update_occupancy(torch.from_numpy(gd0), tm.density_fn,
                                       torch.from_numpy(aabb), idx=idx, jitter=jit)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    # the densities come from two packages' MLPs: float noise, not bits
    np.testing.assert_allclose(tgd.numpy(), np.asarray(jgd), rtol=1e-5)
    share = float(np.asarray(jgrid).mean())
    assert 0.0 < share < 1.0, share
    return np.array(jgrid)


@pytest.mark.parametrize("name", ["vanilla-nerf", "mipnerf"])
def test_coarse_fine_model_matches_jax(name):
    from samnerf_tpu.models import mipnerf as jmip, vanilla_nerf as jvan
    from samnerf_tpu_torch.models import mipnerf as tmip, vanilla_nerf as tvan
    if name == "vanilla-nerf":
        run_case(name, jvan, tvan, "VanillaNerfConfig", "VanillaNerfModel",
                 dict(num_coarse_samples=8, num_importance_samples=8, hidden_dim=16),
                 seed=1, levels=2)
    else:
        run_case(name, jmip, tmip, "MipNerfConfig", "MipNerfModel",
                 dict(num_coarse_samples=8, num_importance_samples=8, hidden_dim=16,
                      pos_frequencies=4), seed=2, levels=2)


def test_tensorf_matches_jax():
    from samnerf_tpu.models import tensorf as jt
    from samnerf_tpu_torch.models import tensorf as tt
    run_case("tensorf", jt, tt, "TensoRFConfig", "TensoRFModel",
             dict(num_uniform_samples=12, num_samples=6, resolution=16,
                  density_components=4, color_components=4, appearance_dim=8),
             seed=3, levels=2)


@pytest.mark.parametrize("name", ["nerfplayer-nerfacto", "nerfplayer-ngp"])
def test_nerfplayer_matches_jax(name):
    from samnerf_tpu.models import nerfplayer as jn
    from samnerf_tpu_torch.models import nerfplayer as tn
    run_case(name, jn, tn, "NerfPlayerConfig", "NerfPlayerModel",
             dict(num_samples=8, num_levels=2, max_res=64, log2_hashmap_size=10,
                  num_time_steps=4, hidden_dim=16),
             seed=4, levels=1, occupancy=name == "nerfplayer-ngp")
