"""The zoo's training loop over many steps in the port against the JAX
package, on the CPU: instant-NGP (with its occupancy grid),
depth-nerfacto and semantic-NeRF-W for 32 steps at small widths on a
small textured scene with depth maps and class masks.

The JAX side is its ``train_zoo`` loop: init from ``PRNGKey(seed)`` on
the batch of ``next_train(0)``, ``make_zoo_train_chunk`` over 16-step
chunks with optax ``adam(lr)`` on ``next_train(s)`` and ``PRNGKey(seed +
s)``, the grid updated between chunks from ``fold_in(fold_in(
PRNGKey(seed), 0x0CC), s)`` by JAX's rule (step > warmup, every 16
steps). The port side is the train entry's loop, one step after another
(``make_zoo_train_step``, ``zoo_optimizer``, ``gather_batch``,
``update_occupancy`` on the entry's schedule), given what JAX drew
through the step's own arguments, as ``test_torch_zoo_hash.py`` gives
one step: JAX's init (``zoo_params_from_jax``), the pixels of each JAX
batch, each step's jitter and background from ``PRNGKey(seed + s)``, and
each grid update's cells and points. Both take a grid warmup of 0 here
(256 in the entries), so 32 steps hold two updates.

Float noise grows over a run: Adam's first update is lr * g / (|g| +
1e-8), so a table entry whose gradient is within float noise of 0 moves
by up to lr either way, and the runs part a little more at every step.
The tolerances are about three times what the port shows (in brackets):

- the losses at the end of each chunk: within 2e-2 of the total loss
  (7e-3, instant-NGP after its second grid update);
- the grid of every update: equal bit for bit where JAX's density is not
  within 1e-4 of the threshold (equal everywhere);
- the parameters after the run: relative L2 error over all of them at
  most 0.15 (0.038 / 0.013 / 0.054);
- eval view 0 rendered from them (each with its own grid): mean absolute
  error at most 2e-2 and largest at most 0.1 (6.5e-3 and 0.038).

A loop that draws other numbers (its own init, batches or jitter) misses
every one of these by far.
"""
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from samnerf_tpu.configs import zoo as jzoo
from samnerf_tpu.core.cameras import generate_rays as jax_rays
from samnerf_tpu.ops import occupancy as jocc
from samnerf_tpu_torch import train as ttrain
from samnerf_tpu_torch.configs import zoo as tzoo
from samnerf_tpu_torch.convert import zoo_params_from_jax
from samnerf_tpu_torch.data.datamanager import DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.ops import occupancy as tocc

torch.set_num_threads(1)

SEED = 42
RAYS = 64
CHUNK = 16
OCC_WARMUP, OCC_RES = 0, 16
TOL_LOSS = 2e-2
TOL_PARAM = 0.15
TOL_RENDER_MEAN = 2e-2
TOL_RENDER_MAX = 0.1
NUM_CLASSES = 5
BASE = dict(distill_sam=False, num_levels=4, max_res=64, log2_hashmap_size=12,
            num_proposal_samples_per_ray=(8,), num_nerf_samples_per_ray=8,
            proposal_net_args=({"hidden_dim": 8, "log2_hashmap_size": 10,
                                "num_levels": 2, "max_res": 32},))
NGP = dict(num_samples=16, num_levels=4, max_res=64, log2_hashmap_size=12,
           grid_resolution=8)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """6 + 1 textured views of 24x24 with a depth map (metres, a tenth of
    the pixels without one) and a class mask per training view."""
    from samnerf_tpu_torch.utils.synthetic import write_textured_scene
    root = write_textured_scene(tmp_path_factory.mktemp("traj") / "scene", num_train=6,
                                num_test=1, h=24, w=24, detail=2.0)
    rng = np.random.default_rng(5)
    (root / "depths").mkdir()
    (root / "semantics").mkdir()
    for frame in json.loads((root / "transforms_train.json").read_text())["frames"]:
        stem = frame["file_path"].split("/")[-1][:-4]
        depth = rng.uniform(1.0, 3.0, (24, 24)).astype(np.float32)
        depth[rng.uniform(size=(24, 24)) < 0.1] = 0.0
        np.save(root / "depths" / f"{stem}.npy", depth)
        Image.fromarray(rng.integers(0, NUM_CLASSES, (24, 24)).astype(np.uint8)).save(
            root / "semantics" / f"{stem}.png")
    return root


def _models(name):
    """(JAX model, its config, port model, its config) at the test widths."""
    if name == "instant-ngp":
        from samnerf_tpu.models import instant_ngp as j
        from samnerf_tpu_torch.models import instant_ngp as t
        jc, tc = j.InstantNGPConfig(**NGP), t.InstantNGPConfig(**NGP)
        return j.InstantNGPModel(jc), jc, t.InstantNGPModel(tc, device="cpu"), tc
    from samnerf_tpu.models.sam_model import SAMModelConfig as JaxBase
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig as PortBase
    if name == "depth-nerfacto":
        from samnerf_tpu.models import depth_nerfacto as j
        from samnerf_tpu_torch.models import depth_nerfacto as t
        jc = j.DepthNerfactoConfig(base=JaxBase(**BASE))
        tc = t.DepthNerfactoConfig(base=PortBase(**BASE))
        return j.DepthNerfactoModel(jc.base), jc, t.DepthNerfactoModel(tc.base, device="cpu"), tc
    from samnerf_tpu.models import semantic_nerfw as j
    from samnerf_tpu_torch.models import semantic_nerfw as t
    jc = j.SemanticNerfWConfig(num_classes=NUM_CLASSES, base=JaxBase(**BASE))
    tc = t.SemanticNerfWConfig(num_classes=NUM_CLASSES, base=PortBase(**BASE))
    return j.SemanticNerfWModel(jc), jc, t.SemanticNerfWModel(tc, device="cpu"), tc


def _jax_datamanager(name, scene):
    from samnerf_tpu.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu.data.datamanagers_extra import DepthDataManager, SemanticDataManager
    from samnerf_tpu.data.dataparser import DataparserConfig
    cls = {"depth-nerfacto": DepthDataManager,
           "semantic-nerfw": SemanticDataManager}.get(name, DataManager)
    return cls(DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True), train_num_rays_per_batch=RAYS), seed=SEED)


def _occ_key(step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 0x0CC), step)


def jax_run(name, scene, steps):
    """JAX's ``train_zoo`` loop at the test widths: (init params, host
    batches [steps], per-chunk last metrics, final params, grids by step
    with their densities)."""
    jm, jcfg, _, _ = _models(name)
    method = jzoo.zoo_methods()[name]
    dm = _jax_datamanager(name, scene)
    cameras = jax.tree.map(jnp.asarray, dm.cameras)
    b0 = {k: jnp.asarray(v) for k, v in dm.next_train(0).items()}
    bundle0 = jax_rays(cameras, b0["indices"][:, 0], b0["indices"][:, 1:].astype(jnp.float32))
    key = jax.random.PRNGKey(SEED)
    params = jax.jit(lambda r, b: jm.init(r, b, rng=r, train=True))(key, bundle0)
    init = params
    opt = optax.adam(method.lr)
    opt_state = opt.init(params)
    chunk_fn = jax.jit(jzoo.make_zoo_train_chunk(method, jm, jcfg, opt))
    occ = grid_density = None
    grids = {}
    if method.use_occupancy:
        grid_density = jnp.zeros((OCC_RES ** 3,), jnp.float32)
        occ = jnp.ones((OCC_RES,) * 3, jnp.float32)

        @jax.jit
        def occ_update(params, grid_density, rng):
            return jocc.update_occupancy(
                grid_density, lambda p: jm.apply(params, p, method=jm.density_fn),
                jnp.asarray([[-1.0] * 3, [1.0] * 3], jnp.float32), rng,
                num_samples=OCC_RES ** 3 // 4)

    batches, metrics = [], []
    for start in range(1, steps + 1, CHUNK):
        host = [dm.next_train(s) for s in range(start, start + CHUNK)]
        batches += host
        stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in host]) for k in host[0]}
        rngs = jnp.stack([jax.random.PRNGKey(SEED + s) for s in range(start, start + CHUNK)])
        if method.use_occupancy:
            if start > OCC_WARMUP and (start - 1) % 16 < CHUNK:
                grid_density, occ = occ_update(params, grid_density, _occ_key(start))
                grids[start] = (np.asarray(occ), np.asarray(grid_density))
            params, opt_state, m = chunk_fn(params, opt_state, cameras, stacked, rngs, occ)
        else:
            params, opt_state, m = chunk_fn(params, opt_state, cameras, stacked, rngs)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batches, metrics, params, grids


def _uniform(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def port_configs(monkeypatch):
    """The port's zoo models at the test widths, as ``method.build`` makes
    them."""
    from samnerf_tpu_torch.models import depth_nerfacto, instant_ngp, semantic_nerfw
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig
    base = SAMModelConfig(**BASE)
    for mod, cls, kw in ((instant_ngp, "InstantNGPConfig", NGP),
                         (depth_nerfacto, "DepthNerfactoConfig", dict(base=base)),
                         (semantic_nerfw, "SemanticNerfWConfig",
                          dict(num_classes=NUM_CLASSES, base=base))):
        monkeypatch.setattr(mod, cls, functools.partial(getattr(mod, cls), **kw))


def jax_draws(name, model, step):
    """The model's random inputs of ``step`` as JAX draws them from
    ``PRNGKey(seed + step)``: instant-NGP one (R, 1) jitter and the
    background ``uniform(fold_in(rng, 7), (R, 3))``, the nerfacto backbone
    one (R, 1) jitter per level of ``split(rng, levels)``."""
    rng = jax.random.PRNGKey(SEED + step)
    if name == "instant-ngp":
        return {"jitter": (_uniform(rng, (RAYS, 1)),),
                "bg_rgb": _uniform(jax.random.fold_in(rng, 7), (RAYS, 3))}
    backbone = getattr(model, "backbone", model)
    levels = len(backbone.config.num_proposal_samples_per_ray) + 1
    return {"jitter": tuple(_uniform(k, (RAYS, 1)) for k in jax.random.split(rng, levels))}


def port_run(name, scene, init, batches, monkeypatch):
    """The train entry's loop in the port on the CPU, on JAX's init, JAX's
    batches and JAX's draws: (per-chunk last metrics, final state, grids
    by step)."""
    from samnerf_tpu_torch.data.device_data import build_device_dataset, gather_batch

    port_configs(monkeypatch)
    method = tzoo.zoo_methods()[name]
    model, cfg = method.build(device="cpu")
    model.load_state_dict(zoo_params_from_jax(name, jax.tree.map(np.asarray, init)))
    dm = ttrain._zoo_datamanager(name, DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True), train_num_rays_per_batch=RAYS), SEED)
    data = build_device_dataset(dm, "cpu")
    hw = (dm.cameras.height, dm.cameras.width)
    step_fn = tzoo.make_zoo_train_step(method, model, cfg, tzoo.zoo_optimizer(model, method.lr))
    grid = grid_density = None
    if method.use_occupancy:
        grid_density = torch.zeros((OCC_RES ** 3,))
        grid = torch.ones((OCC_RES,) * 3)
    metrics, grids = [], {}
    for step, host in enumerate(batches, start=1):
        if method.use_occupancy and step > OCC_WARMUP and (step - 1) % 16 == 0:
            k1, k2 = jax.random.split(_occ_key(step))
            n = OCC_RES ** 3 // 4
            grid_density, grid = tocc.update_occupancy(
                grid_density, model.density_fn, model.aabb,
                idx=torch.from_numpy(np.array(jax.random.randint(k1, (n,), 0, OCC_RES ** 3))),
                jitter=_uniform(k2, (n, 3)))
            grids[step] = grid.numpy().copy()
        batch = gather_batch(data, torch.from_numpy(host["indices"]).long(), 1, hw)
        m = step_fn(dm.cameras, batch, None, grid, jax_draws(name, model, step))
        if step % CHUNK == 0:
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model.state_dict(), grids


def eval_renders(name, scene, jparams, jgrid, tstate, tgrid):
    """rgb of eval view 0 rendered by JAX's model on its params and by the
    port's on its state (each with its own grid): ([H*W, 3], [H*W, 3])."""
    from samnerf_tpu.engine.eval_render import _chunked_coords
    from samnerf_tpu_torch.core.cameras import generate_rays

    jm, _, tm, _ = _models(name)
    dm = _jax_datamanager(name, scene)
    ec = jax.tree.map(jnp.asarray, dm.eval_cameras)
    h, w = ec.height, ec.width
    coords = _chunked_coords(h, w, h * w)[0]
    kw = {} if jgrid is None else {"occupancy": jnp.asarray(jgrid)}
    ref = jax.jit(lambda p, c: jm.apply(p, jax_rays(ec, jnp.zeros((h * w,), jnp.int32), c),
                                        train=False, **kw)["rgb"])(jparams, jnp.asarray(coords))
    tm.load_state_dict(tstate)
    pdm = ttrain._zoo_datamanager(name, DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True)), SEED)
    ci = torch.zeros((h * w,), dtype=torch.long)
    out = tm(generate_rays(pdm.eval_cameras, ci, torch.from_numpy(coords)), train=False,
             **({} if tgrid is None else {"occupancy": torch.from_numpy(tgrid)}))["rgb"]
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name,steps", [("instant-ngp", 2 * CHUNK),
                                        ("depth-nerfacto", 2 * CHUNK),
                                        ("semantic-nerfw", 2 * CHUNK)])
def test_zoo_loop_tracks_jax(name, steps, scene, monkeypatch):
    init, batches, jmetrics, jparams, jgrids = jax_run(name, scene, steps)
    tmetrics, tstate, tgrids = port_run(name, scene, init, batches, monkeypatch)

    assert len(tmetrics) == len(jmetrics) == steps // CHUNK
    for c, (tm_, jm_) in enumerate(zip(tmetrics, jmetrics)):
        assert set(tm_) == set(jm_), (tm_, jm_)
        for k in jm_:
            np.testing.assert_allclose(tm_[k], jm_[k], rtol=TOL_LOSS,
                                       atol=TOL_LOSS * jm_["total_loss"],
                                       err_msg=f"{k} after chunk {c}")

    assert sorted(tgrids) == sorted(jgrids)
    for step, (jgrid, jdensity) in jgrids.items():
        near = np.abs(jdensity - 0.01).reshape(jgrid.shape) < 1e-4
        np.testing.assert_array_equal(tgrids[step][~near], jgrid[~near],
                                      err_msg=f"grid before step {step}")
        assert 0.0 < jgrid.mean() <= 1.0

    ref = zoo_params_from_jax(name, jax.tree.map(np.asarray, jparams))
    assert set(ref) == set(tstate)
    err = (sum(float(((tstate[n] - r) ** 2).sum()) for n, r in ref.items())
           / sum(float((r ** 2).sum()) for r in ref.values())) ** 0.5
    assert err <= TOL_PARAM, f"parameters: relative L2 error {err:.3e}"
    last = max(jgrids) if jgrids else None
    rgb, rgb_ref = eval_renders(name, scene, jparams, None if last is None else jgrids[last][0],
                                tstate, None if last is None else tgrids[last])
    assert np.abs(rgb - rgb_ref).mean() <= TOL_RENDER_MEAN
    np.testing.assert_allclose(rgb, rgb_ref, atol=TOL_RENDER_MAX, rtol=0)
