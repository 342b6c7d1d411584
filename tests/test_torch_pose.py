"""Pose refinement of the port against the JAX package, on the CPU.

- ``exp_map_SO3xR3`` and ``exp_map_SE3`` on random tangents with rotation
  magnitudes on both sides of SE3's series threshold (1e-2): atol 1e-6;
  their gradients against ``jax.grad`` away from zero: rtol 1e-5 /
  atol 1e-6.
- At a zero tangent the JAX ``exp_map_SE3`` gradient is NaN in the
  rotation columns (``sqrt`` of |w|^2 is taken before the series branch is
  chosen); the port's is finite and within 1e-5 of its value at
  |w| = 1e-6.
- ``CameraOptimizer`` in each mode against the flax module with the same
  ``pose_adjustment``: atol 1e-6; an unknown mode raises ValueError.
- ``generate_rays`` with ``camera_opt_to_camera`` with and without a crop
  box, with distortion and with fisheye / equirectangular cameras: the
  tolerances of ``test_torch_cameras_distortion.py`` (origins atol 1e-6
  here, since the deltas' products round in another order).
- The gradient of a tiny model's rgb loss with respect to an SO3xR3
  ``pose_adjustment`` (through the ray directions: the hash encodes give
  no position gradient in either package): rtol 2e-3, atol 1% of the
  largest component (each component sums over every ray with
  cancellation, and the jitted JAX gradient sums in another order).
- ``utils/misc.py`` against JAX's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.core import camera_optimizers as jco
from samnerf_tpu.core import cameras as jc
from samnerf_tpu.core import lie_groups as jlg
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu.utils import misc as jmisc
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core import camera_optimizers as tco
from samnerf_tpu_torch.core import cameras as tc
from samnerf_tpu_torch.core import lie_groups as tlg
from samnerf_tpu_torch.models import sam_model as tm
from samnerf_tpu_torch.utils import misc as tmisc

from test_torch_cameras_distortion import DIST, N, _both
from test_torch_serve_slice import _model_params, port_config
from test_model import TINY

MAPS = [("SO3xR3", jlg.exp_map_SO3xR3, tlg.exp_map_SO3xR3),
        ("SE3", jlg.exp_map_SE3, tlg.exp_map_SE3)]


def _tangents(seed=0, n=12):
    """Rows with rotation magnitudes from 1e-5 to 1.5 (both SE3 branches)."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, 6))
    mags = np.geomspace(1e-5, 1.5, n)
    t[:, 3:] *= (mags / np.linalg.norm(t[:, 3:], axis=-1))[:, None]
    return t.astype(np.float32)


@pytest.mark.parametrize("name,jfn,tfn", MAPS)
def test_exp_map_forward_matches_jax(name, jfn, tfn):
    t = _tangents()
    assert (np.linalg.norm(t[:, 3:], axis=-1) < 1e-2).sum() >= 4
    np.testing.assert_allclose(tfn(torch.from_numpy(t)).numpy(),
                               np.asarray(jfn(jnp.asarray(t))), atol=1e-6, rtol=0)
    a, b = torch.from_numpy(t[:6].reshape(2, 3, 6)), jnp.asarray(t[:6].reshape(2, 3, 6))
    np.testing.assert_allclose(tfn(a).numpy(), np.asarray(jfn(b)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,jfn,tfn", MAPS)
def test_exp_map_grad_matches_jax(name, jfn, tfn):
    t = _tangents(seed=1)
    t = t[np.linalg.norm(t[:, 3:], axis=-1) > 1e-3]
    w = np.random.default_rng(2).normal(size=(t.shape[0], 3, 4)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(t))
    x = torch.from_numpy(t).requires_grad_()
    torch.sum(tfn(x) * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_exp_map_se3_grad_finite_at_zero():
    """Queue C (u): JAX's gradient at a zero tangent is NaN in the rotation
    columns; the port keeps the forward values and a finite gradient."""
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jlg.exp_map_SE3(x) ** 2))(
        jnp.zeros((2, 6))))
    assert np.isnan(ref[:, 3:]).all() and (ref[:, :3] == 0).all()
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 4)).astype(np.float32))

    def grad_at(t):
        x = torch.tensor(t, dtype=torch.float32).requires_grad_()
        torch.sum(tlg.exp_map_SE3(x) * w).backward()
        return x.grad.numpy()

    g0 = grad_at(np.zeros((2, 6)))
    tiny = np.zeros((2, 6))
    tiny[:, 3:] = [[1e-6, 0, 0], [0, -6e-7, 8e-7]]
    assert np.isfinite(g0).all()
    np.testing.assert_allclose(g0, grad_at(tiny), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tlg.exp_map_SE3(torch.zeros(2, 6)).numpy(),
                                  np.asarray(jlg.exp_map_SE3(jnp.zeros((2, 6)))))


def test_multiply_poses_matches_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(5, 3, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tlg.multiply_poses(torch.from_numpy(a), torch.from_numpy(b)),
                               np.asarray(jlg.multiply_poses(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["off", "SO3xR3", "SE3"])
def test_camera_optimizer_matches_jax(mode):
    adj = (np.random.default_rng(5).normal(size=(4, 6)) * 0.05).astype(np.float32)
    adj[1] = 0.0                                          # one camera untouched
    idx = np.array([0, 1, 3, 3, 2], np.int32)
    jmod = jco.CameraOptimizer(num_cameras=4, mode=mode)
    params = {"params": {"pose_adjustment": jnp.asarray(adj)}} if mode != "off" else {}
    ref = np.array(jmod.apply(params, jnp.asarray(idx)))
    opt = tco.CameraOptimizer(4, mode, device="cpu")
    if mode == "off":
        assert not list(opt.parameters())
    else:
        assert opt.pose_adjustment.shape == (4, 6) and not opt.pose_adjustment.any()
        with torch.no_grad():
            opt.pose_adjustment.copy_(torch.from_numpy(adj))
    np.testing.assert_allclose(opt(torch.from_numpy(idx)).detach().numpy(), ref, atol=1e-6,
                               rtol=0)
    c2w = np.random.default_rng(6).normal(size=(5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tco.apply_pose_adjustment(torch.from_numpy(c2w), torch.from_numpy(ref)).numpy(),
        np.asarray(jco.apply_pose_adjustment(jnp.asarray(c2w), jnp.asarray(ref))), atol=1e-6)
    assert tco.apply_pose_adjustment(torch.from_numpy(c2w), None) is not None


def test_camera_optimizer_unknown_mode_raises():
    with pytest.raises(ValueError):
        jco.CameraOptimizer(num_cameras=2, mode="SE2").init(jax.random.PRNGKey(0),
                                                            jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError):
        tco.CameraOptimizer(2, "SE2", device="cpu")


def _deltas(n, seed=7, mode="SE3"):
    t = (np.random.default_rng(seed).normal(size=(n, 6)) * 0.05).astype(np.float32)
    fn = jlg.exp_map_SE3 if mode == "SE3" else jlg.exp_map_SO3xR3
    return np.asarray(fn(jnp.asarray(t)))


@pytest.mark.parametrize("kind", ["perspective", "crop", "distorted", "fisheye_equirect"])
def test_generate_rays_with_pose_deltas_matches_jax(kind):
    ctype = [1, 2, 3] if kind == "fisheye_equirect" else None
    jcams, tcams, idx, coords = _both(ctype=ctype, dist=DIST if kind == "distorted" else None)
    delta = _deltas(idx.shape[0])
    aabb = np.array([[-0.3, -0.2, -0.4], [0.5, 0.3, 0.2]], np.float32)
    kw_j = dict(camera_opt_to_camera=jnp.asarray(delta))
    kw_t = dict(camera_opt_to_camera=torch.from_numpy(delta))
    if kind == "crop":
        kw_j["aabb_box"], kw_t["aabb_box"] = jnp.asarray(aabb), torch.from_numpy(aabb)
    jr = jc.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords), **kw_j)
    tr = tc.generate_rays(tcams, torch.from_numpy(idx), torch.from_numpy(coords), **kw_t)
    np.testing.assert_allclose(tr.origins.numpy(), np.asarray(jr.origins), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tr.directions.numpy(), np.asarray(jr.directions), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tr.pixel_area.numpy(), np.asarray(jr.pixel_area), rtol=1e-4)
    plain = tc.generate_rays(tcams, torch.from_numpy(idx), torch.from_numpy(coords))
    assert (tr.directions - plain.directions).abs().max() > 1e-3     # deltas do move rays
    if kind == "crop":
        np.testing.assert_allclose(tr.nears.numpy(), np.asarray(jr.nears), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tr.fars.numpy(), np.asarray(jr.fars), atol=1e-5,
                                   rtol=1e-5)
        assert (tr.fars > tr.nears).any()


def test_pose_gradient_through_tiny_model_matches_jax():
    cfg = dataclasses.replace(TINY, hash_fn="morton", distill_sam=False)
    params = _model_params(dataclasses.replace(TINY, hash_fn="morton"), seed=5)
    params = {"params": {k: v for k, v in params["params"].items()
                         if k in ("fields", "proposal_networks_0")}}
    jcams, tcams, idx, coords = _both()
    target = np.random.default_rng(8).uniform(size=(idx.shape[0], 3)).astype(np.float32)
    adj = (np.random.default_rng(9).normal(size=(N, 6)) * 0.02).astype(np.float32)
    jmodel = jm.SAMModel(cfg)
    jopt = jco.CameraOptimizer(num_cameras=N, mode="SO3xR3")

    def jloss(a):
        delta = jopt.apply({"params": {"pose_adjustment": a}}, jnp.asarray(idx))
        rb = jc.generate_rays(jcams, jnp.asarray(idx), jnp.asarray(coords),
                              camera_opt_to_camera=delta)
        out = jmodel.apply(params, rb, rng=None, train=True, get_features=())
        return jnp.mean((out["rgb"] - target) ** 2)

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(adj))

    model = tm.SAMModel(port_config(cfg), device="cpu")
    model.load_state_dict(params_from_jax(params))
    opt = tco.CameraOptimizer(N, "SO3xR3", device="cpu")
    with torch.no_grad():
        opt.pose_adjustment.copy_(torch.from_numpy(adj))
    ti = torch.from_numpy(idx)
    rb = tc.generate_rays(tcams, ti, torch.from_numpy(coords), camera_opt_to_camera=opt(ti))
    loss = torch.mean((model(rb, train=True)["rgb"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    g = opt.pose_adjustment.grad.numpy()
    assert np.abs(g).max() > 1e-6
    ref = np.asarray(jgrad)
    np.testing.assert_allclose(g, ref, rtol=2e-3, atol=1e-2 * np.abs(ref).max())


def test_misc_matches_jax():
    for step, size, zero in [(0, 5, False), (0, 5, True), (10, 5, False), (7, 5, False),
                             (3, 0, True)]:
        assert tmisc.step_check(step, size, zero) == jmisc.step_check(step, size, zero)
    rng = np.random.default_rng(10)
    o = rng.normal(size=(50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d[0, 1] = 0.0
    aabb = np.array([-0.5, -0.4, -0.3, 0.5, 0.6, 0.7], np.float32)
    for a, b in zip(tmisc.intersect_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                         torch.from_numpy(aabb)),
                    jmisc.intersect_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert tc.intersect_aabb is tmisc.intersect_aabb
    np.testing.assert_allclose(tmisc.safe_normalize(torch.from_numpy(d)).numpy(),
                               np.asarray(jmisc.safe_normalize(jnp.asarray(d))), atol=1e-7)
    scaled = tmisc.scale_dict({"a": torch.tensor(2.0), "b": torch.tensor(3.0)}, {"a": 0.5})
    ref = jmisc.scale_dict({"a": jnp.asarray(2.0), "b": jnp.asarray(3.0)}, {"a": 0.5})
    assert {k: float(v) for k, v in scaled.items()} == {k: float(v) for k, v in ref.items()}
