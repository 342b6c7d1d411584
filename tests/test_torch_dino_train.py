"""DINO distillation and appearance embeddings in the port against the JAX
package, on the CPU.

The tiny model of ``tests/test_model.py`` with ``use_dino_feature`` and
with ``use_appearance_embedding`` (3 training images), numpy-drawn flax
weights (``test_torch_serve_slice._model_params``' scheme):

- the DINO head and the eval forward (rgb, SAM, DINO, ClipSeg) at rtol
  1e-5 / atol 1e-5 (f32 sums of sharpened weights times features in
  another order; ``test_torch_serve_slice.py`` holds a whole frame at
  1e-4), the nerfacto field alone at atol 1e-6, and the rule that a DINO request keeps the SAM head
  off the fused route;
- one train step with the DINO target (NaN where a pixel has none): the
  loss dict at rtol 1e-4, dense gradients at rtol 1e-3 / atol 1e-5 and
  hash tables at rtol 1e-2 / atol 1e-4 (``test_torch_train_step.py``'s
  tolerances and reasons);
- appearance embeddings: the eval forward (mean embedding, or zeros),
  and a train step over three cameras whose embedding rows get their
  gradients;
- ``train_checkpoint_from_jax`` carries ``dino_net`` and
  ``embedding_appearance`` with their Adam moments;
- the CLI flags, the trainer's features, ``num_images`` from the data and
  the optimizer group of the DINO head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samnerf_tpu.core.cameras import Cameras as JaxCameras, generate_rays as jax_rays
from samnerf_tpu.engine.optimizers import OptimizerGroupConfig as JaxGroup
from samnerf_tpu.engine.optimizers import build_optimizer as jax_optimizer
from samnerf_tpu.fields import nerfacto_field as jnf
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.convert import params_from_jax, train_checkpoint_from_jax
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.data.device_data import indices_from_uniform, uniform_shape
from samnerf_tpu_torch.engine.optimizers import GroupedAdam
from samnerf_tpu_torch.engine.trainer import TrainState, loss_and_grads
from samnerf_tpu_torch.fields import nerfacto_field as tnf
from samnerf_tpu_torch.fields import sam_field as tsf
from samnerf_tpu_torch.models import sam_model as tm

from test_model import TINY, make_bundle
from test_torch_convert import port_config

H = W = 32
R = 64
C2W = np.array([[[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.6]],
                [[1, 0, 0, -0.05], [0, 1, 0, 0.03], [0, 0, 1, 0.55]],
                [[1, 0, 0, 0.0], [0, 1, 0, 0.0], [0, 0, 1, 0.65]]], np.float32)
DINO = dataclasses.replace(TINY, hash_fn="morton", use_dino_feature=True)
APPEAR = dataclasses.replace(TINY, hash_fn="morton", use_appearance_embedding=True,
                             num_images=3)
ALL = ("sam", "dino", "clipseg")
RTOL, ATOL = 1e-5, 1e-6
MODEL_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(cfg, seed=0):
    """Flax params of ``cfg`` (every head built) drawn with numpy: tables
    U(-0.5, 0.5), biases N(0, 0.1), other leaves N(0, 1 / fan_in)."""
    shapes = jax.eval_shape(lambda: jm.SAMModel(cfg).init(
        jax.random.PRNGKey(0), make_bundle(16), rng=jax.random.PRNGKey(1),
        train=False, get_features=ALL))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "table" in name:
            return rng.uniform(-0.5, 0.5, s.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0.0, 1.0, s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cfg, params):
    model = tm.SAMModel(port_config(cfg), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _port_bundle(jb):
    return RayBundle(origins=torch.from_numpy(np.array(jb.origins)),
                     directions=torch.from_numpy(np.array(jb.directions)),
                     pixel_area=torch.from_numpy(np.array(jb.pixel_area)),
                     camera_indices=torch.from_numpy(np.array(jb.camera_indices)))


def test_dino_params_follow_the_flax_tree():
    params = _params(DINO)
    assert "dino_net" in params["params"]["sam_field"]
    model = _port(DINO, params)
    assert model.sam_field.dino_net.layers[-1].out_features == 384
    assert model.sam_field.dino_net.layers[0].in_features == 2 * 2 * 8


def test_eval_forward_with_dino_matches_jax():
    params = _params(DINO, seed=1)
    jb = make_bundle(32, seed=2)
    ref = jm.SAMModel(DINO).apply(params, jb, train=False, get_features=ALL)
    out = _port(DINO, params)(_port_bundle(jb), get_features=ALL)
    for k in ("rgb", "depth", "accumulation", "sam", "dino", "clipseg"):
        assert out[k].shape == tuple(ref[k].shape), k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL,
                                   atol=MODEL_ATOL, err_msg=k)
    assert out["dino"].shape == (32, 384)


def test_dino_request_keeps_the_sam_head_unfused(monkeypatch):
    """JAX's rule: a request for ``dino`` reads the SAM pyramids once for
    both heads, so the SAM head leaves the fused route; without it, the
    SAM head fuses."""
    calls = []
    monkeypatch.setattr(tsf, "_fused_encode_mlp",
                        lambda encs, net, flat: calls.append(net) or torch.zeros(
                            flat.shape[0], net.layers[-1].out_features))
    field = tsf.SAMField(grid_layers=(2, 2), grid_sizes=(8, 8),
                         grid_resolutions=((16, 32), (32, 64)), use_dino=True,
                         use_clipseg=False, hash_q8=True, fuse_mlp=True, device="cpu")
    for p in field.parameters():
        torch.nn.init.normal_(p, std=0.1)
    pos = torch.rand(4, 3, 3)
    with torch.no_grad():
        out = field(pos, ("sam", "dino"))
        assert not calls and set(out) == {"sam", "dino"}
        out = field(pos, ("dino",))
        assert not calls and set(out) == {"dino"}
        out = field(pos, ("sam",))
    assert calls == [field.sam_net] and set(out) == {"sam"}


def _cams(n):
    return (JaxCameras(camera_to_worlds=jnp.asarray(C2W[:n]), fx=jnp.full((n, 1), 30.0),
                       fy=jnp.full((n, 1), 30.0), cx=jnp.full((n, 1), W / 2.0),
                       cy=jnp.full((n, 1), H / 2.0), width=W, height=H),
            Cameras(camera_to_worlds=torch.from_numpy(C2W[:n]), fx=torch.full((n, 1), 30.0),
                    fy=torch.full((n, 1), 30.0), cx=torch.full((n, 1), W / 2.0),
                    cy=torch.full((n, 1), H / 2.0), width=W, height=H))


def _batch(cfg, num_images, seed=0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random(uniform_shape(R, cfg.patch_size)))
    indices = indices_from_uniform(u, num_images, H, W, cfg.patch_size).numpy().astype(np.int32)
    batch = {"indices": indices, "image": rng.uniform(size=(R, 3)).astype(np.float32)}
    if cfg.distill_sam:
        batch["sam"] = rng.normal(size=(R // cfg.patch_size ** 2, 256)).astype(np.float32)
        batch["clipseg"] = rng.normal(size=(R, 192)).astype(np.float32)
        batch["clipseg"][[3, 40]] = np.nan
    if cfg.use_dino_feature:
        batch["dino"] = rng.normal(size=(R, 384)).astype(np.float32)
        batch["dino"][[5, 17, 60]] = np.nan              # pixels without a DINO target
    return batch


def _train_step_both(cfg, features, num_images, step=3, since=0, seed=5):
    """(port loss dict, port model, JAX loss dict, JAX grads as a port state)."""
    params = _params(cfg, seed=seed)
    batch = _batch(cfg, num_images)
    jcams, tcams = _cams(num_images)
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, len(cfg.num_proposal_samples_per_ray) + 1)
    jitter = [np.array(jax.random.uniform(k, (R, 1))) for k in keys]
    tcfg = port_config(cfg)
    anneal = tm.proposal_anneal_value(tcfg, step)
    gate = tm.proposal_grad_gate(tcfg, step, since)
    model = jm.SAMModel(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        idx = jbatch["indices"]
        rb = jax_rays(jcams, idx[:, 0], idx[:, 1:])
        out = model.apply(p, rb, rng=rng, train=True, anneal=anneal, proposal_grad=gate,
                          get_features=features)
        ld = jm.get_loss_dict(cfg, out, jbatch)
        return sum(ld.values()), ld

    (_, ref_ld), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port(cfg, params)
    ld, _, _ = loss_and_grads(port, tcfg, TrainState(step, since), tcams,
                              {k: torch.from_numpy(v) for k, v in batch.items()}, features,
                              jitter=[torch.from_numpy(j) for j in jitter])
    return ld, port, ref_ld, params_from_jax(jax.tree.map(np.asarray, ref_grads)), batch


def _assert_grads(port, ref):
    named = dict(port.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        assert p.grad is not None, name
        tol = (dict(rtol=1e-2, atol=1e-4) if name.endswith("table")
               else dict(rtol=1e-3, atol=1e-5))
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), err_msg=name, **tol)


def test_dino_train_step_matches_jax():
    ld, port, ref_ld, ref, _ = _train_step_both(DINO, ALL, 1)
    assert set(ld) == set(ref_ld) == {"rgb_loss", "interlevel_loss", "distortion_loss",
                                      "sam_loss", "dino_loss", "clipseg_loss"}
    for k in ld:
        np.testing.assert_allclose(ld[k].item(), float(ref_ld[k]), rtol=1e-4, err_msg=k)
    _assert_grads(port, ref)
    named = dict(port.named_parameters())
    assert named["sam_field.dino_net.layers.0.weight"].grad.abs().sum() > 0
    # the DINO loss reaches the SAM pyramids that feed the head
    assert named["sam_field.sam_enc.1.table"].grad.abs().sum() > 0


def test_dino_loss_alone_trains_the_sam_pyramids():
    """With only the DINO target's loss, the SAM pyramids get the head's
    gradient and the SAM head gets none."""
    cfg = port_config(DINO)
    model = _port(DINO, _params(DINO, seed=3))
    bundle = _port_bundle(make_bundle(16, seed=4))
    out = model(bundle, get_features=("sam", "dino"), train=True)
    target = torch.from_numpy(np.random.default_rng(6).normal(size=(16, 384)).astype(np.float32))
    loss = tm.get_loss_dict(cfg, out, {"image": out["rgb"].detach(),
                                       "sam": out["sam"].detach(), "dino": target})["dino_loss"]
    loss.backward()
    named = dict(model.named_parameters())
    assert named["sam_field.sam_enc.0.table"].grad.abs().sum() > 0
    assert named["sam_field.sam_net.layers.0.weight"].grad is None


def test_appearance_eval_forward_matches_jax():
    params = _params(APPEAR, seed=8)
    jb = make_bundle(32, seed=9)
    ref = jm.SAMModel(APPEAR).apply(params, jb, train=False, get_features=("sam", "clipseg"))
    out = _port(APPEAR, params)(_port_bundle(jb), get_features=("sam", "clipseg"))
    for k in ("rgb", "depth", "sam", "clipseg"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL,
                                   atol=MODEL_ATOL, err_msg=k)


@pytest.mark.parametrize("average", (True, False))
@pytest.mark.parametrize("train", (True, False))
def test_appearance_field_matches_jax(average, train):
    """The nerfacto field alone: the camera's embedding in training, the
    mean embedding (``use_average_appearance_embedding``) or zeros at
    eval."""
    kw = dict(num_levels=4, max_res=64, log2_hashmap_size=10, num_images=3,
              use_appearance_embedding=True, use_average_appearance_embedding=average)
    rng = np.random.default_rng(10)
    pos = jnp.asarray(rng.uniform(-0.8, 0.8, (8, 5, 3)).astype(np.float32))
    d = rng.normal(size=(8, 3))
    dirs = jnp.asarray((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    ci = jnp.asarray(rng.integers(0, 3, (8, 1)).astype(np.int32))
    jf = jnf.NerfactoField(**kw)
    shapes = jax.eval_shape(lambda: jf.init(jax.random.PRNGKey(0), pos, dirs, ci, True))

    def draw(path, s):
        if "table" in jax.tree_util.keystr(path):
            return rng.uniform(-0.5, 0.5, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.5, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    ref = jf.apply(params, pos, dirs, ci, train)
    field = tnf.NerfactoField(**kw, device="cpu")
    field.load_state_dict(params_from_jax(params))
    out = field(torch.from_numpy(np.array(pos)), torch.from_numpy(np.array(dirs)),
                camera_indices=torch.from_numpy(np.array(ci)), train=train)
    for k in ("density", "rgb"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_appearance_train_step_matches_jax():
    ld, port, ref_ld, ref, batch = _train_step_both(APPEAR, ("sam", "clipseg"), 3, seed=11)
    for k in ld:
        np.testing.assert_allclose(ld[k].item(), float(ref_ld[k]), rtol=1e-4, err_msg=k)
    _assert_grads(port, ref)
    grad = port.fields.embedding_appearance.weight.grad
    used = np.unique(batch["indices"][:, 0])
    assert len(used) > 1
    assert all(grad[i].abs().sum() > 0 for i in used)


def test_checkpoint_bridge_carries_dino_and_embeddings():
    cfg = dataclasses.replace(DINO, use_appearance_embedding=True, num_images=3)
    params = _params(cfg, seed=12)
    groups = {g: JaxGroup(lr=1e-3) for g in ("proposal_networks", "fields", "sam_field",
                                             "conv")}
    tx = jax_optimizer(groups, params)
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params)
    _, opt_state = tx.update(grads, opt_state, params)
    opt_state = jax.tree.map(np.asarray, opt_state)
    out = train_checkpoint_from_jax({"params": params, "opt_state": opt_state, "step": 1,
                                     "steps_since_update": 0})
    model = _port(cfg, params)
    assert set(out["model"]) == set(model.state_dict())
    for name in ("sam_field.dino_net.layers.1.weight", "fields.embedding_appearance.weight"):
        assert name in out["optimizer"]["optimizer"]["state"], name
        st = out["optimizer"]["optimizer"]["state"][name]
        assert st["exp_avg"].shape == model.state_dict()[name].shape
        assert float(st["exp_avg"].abs().max()) > 0
    emb = np.asarray(params["params"]["fields"]["embedding_appearance"]["embedding"])
    np.testing.assert_array_equal(out["model"]["fields.embedding_appearance.weight"].numpy(),
                                  emb)


def test_cli_turns_dino_on_and_the_trainer_asks_for_it():
    config = train_cli.parse(["samnerf_distill", "--model.use-dino-feature", "True",
                              "--datamanager.use-dino-feature", "True",
                              "--model.dino-loss-weight", "0.5"])
    assert config.model.use_dino_feature and config.datamanager.use_dino_feature
    assert config.model.dino_loss_weight == 0.5
    model = tm.SAMModel(dataclasses.replace(port_config(TINY), use_dino_feature=True,
                                            use_appearance_embedding=True, num_images=3),
                        device="meta")
    adam = GroupedAdam(config.optimizers, model)
    named = dict(model.named_parameters())
    for name, group in (("sam_field.dino_net.layers.0.weight", "sam_field"),
                        ("fields.embedding_appearance.weight", "fields")):
        owner = next(g["name"] for g in adam.optimizer.param_groups
                     if any(p is named[name] for p in g["params"]))
        assert owner == group, name


def test_train_loop_distils_extracted_dino_features(tmp_path, monkeypatch):
    """The user's path on a small scene: ``get_dino_embeddings.main`` writes
    ``dino_features/``, then ``train_loop`` with both DINO flags trains on
    them: ``num_images`` comes from the data, the batch carries the DINO
    target at every ray, and the DINO loss falls."""
    from samnerf_tpu_torch.configs.methods import method_configs
    from samnerf_tpu_torch.preprocessing import get_dino_embeddings as tdino
    from samnerf_tpu_torch.utils import synthetic

    from test_torch_dino import TINY as TINY_DINO
    from test_torch_train_slice import GROUPS, TINY as TRAIN_TINY

    scene = synthetic.write_scene(tmp_path / "scene", num_train=3, num_test=1, h=32, w=32,
                                  with_features=True, feature_long_side=8)
    monkeypatch.setitem(tdino._SPECS, "dino_vits8", {**TINY_DINO, "width": 384, "heads": 6})
    tdino.main([str(scene), "--output-path", str(scene / "dino_features"), "--layer", "1"],
               device="cpu")
    assert len(list((scene / "dino_features").glob("*.pt"))) == 4

    config = train_cli.parse(["samnerf_distill", "--data", str(scene),
                              "--model.use-dino-feature", "True",
                              "--datamanager.use-dino-feature", "True",
                              "--trainer.max-num-iterations", "25",
                              "--datamanager.train-num-rays-per-batch", "256",
                              "--vis", "json"])
    config.model = dataclasses.replace(TRAIN_TINY, use_dino_feature=True)
    config.datamanager.patch_size = TRAIN_TINY.patch_size
    config.optimizers = GROUPS
    config.trainer.output_dir = tmp_path / "out"
    config.trainer.steps_per_save = 100000
    config.trainer.steps_per_dispatch = 1            # one callback a step
    losses = []
    trainer = train_cli.train_loop(config, device="cpu",
                                   step_callback=lambda s, m: losses.append(
                                       float(m["dino_loss"])))
    assert trainer.model_cfg.num_images == 3 == trainer.datamanager.num_train_images
    assert trainer.get_features == ("sam", "dino", "clipseg")
    assert trainer.device_data["dino_features"].shape == (3, 7, 7, 384)
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert method_configs()["samnerf_distill"].model.use_dino_feature is False
