"""The zoo's scan chunks in the port, on the CPU (the card replays each
chunk as a CUDA graph; here the same steps run eagerly):

- every zoo method: the hash ones (depth-nerfacto, semantic-nerfw), the
  plain ones (vanilla-nerf, mipnerf, tensorf), nerfplayer-nerfacto (in
  chunks of 2) and two with the occupancy grid (instant-ngp in chunks of
  16, nerfplayer-ngp in chunks of 2, the grid updated between chunks):
  ``dispatch_chunk`` chunks
  of ``make_zoo_train_chunk`` against the same steps run one by one
  through ``make_zoo_train_step`` with ``device_step`` scalars, from one
  seed: parameters, Adam moments, metrics and the grid bit for bit;
- ``train.main`` in chunks against the same run in chunks of one step;
- the cadence of JAX's ``train_zoo`` (its chunk stubbed, so that only its
  loop runs): the iteration count rounded up to a whole chunk, the steps
  it logs and the steps its grid is updated before, for
  ``--max-num-iterations`` 20 and 300, against the port's ``train.main``.
"""
import re

import numpy as np
import pytest
import torch

from samnerf_tpu_torch import train as ttrain
from samnerf_tpu_torch.configs import zoo as tzoo
from samnerf_tpu_torch.utils.synthetic import write_scene

from torch_zoo_tiny import SIZE, tiny_configs, write_extras

torch.set_num_threads(1)

RAYS = 64
LOG_LINE = re.compile(r"^step (\d+): loss=", re.M)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    s = write_scene(tmp_path_factory.mktemp("zoo_chunk") / "scene", num_train=3,
                    num_test=1, h=SIZE, w=SIZE)
    write_extras(s)
    return s


def _args(name, scene, *extra):
    return ttrain.zoo_arg_parser(name).parse_args(
        ["--data", str(scene), "--rays-per-batch", str(RAYS), *extra])


def _state(zs):
    opt = zs.optimizer.state_dict()
    return ({k: v.clone() for k, v in zs.model.state_dict().items()},
            {n: (s["exp_avg"].clone(), s["exp_avg_sq"].clone())
             for n, s in opt["optimizer"]["state"].items()},
            opt["count"], None if zs.occupancy is None else zs.occupancy.clone())


def _assert_same_state(a, b):
    (pa, ma, ca, ga), (pb, mb, cb, gb) = a, b
    assert ca == cb and pa.keys() == pb.keys() and ma.keys() == mb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for k in ma:
        assert torch.equal(ma[k][0], mb[k][0]) and torch.equal(ma[k][1], mb[k][1]), k
    assert (ga is None) == (gb is None) and (ga is None or torch.equal(ga, gb))


@pytest.mark.parametrize("name", ["depth-nerfacto", "vanilla-nerf", "instant-ngp",
                                  "nerfplayer-ngp", "semantic-nerfw", "tensorf", "mipnerf",
                                  "nerfplayer-nerfacto"])
def test_chunks_equal_the_steps_one_by_one(name, scene, monkeypatch):
    """Two chunks against as many single steps, the grid warm-up cut so
    that the grid is updated before step 17 (chunks of 16) or step 1
    (chunks of 2)."""
    tiny_configs(monkeypatch)
    chunk = tzoo.zoo_methods()[name].dispatch_chunk
    warmup = chunk if chunk == ttrain.OCC_EVERY else 0
    monkeypatch.setattr(ttrain, "OCC_WARMUP", warmup)
    args = _args(name, scene)
    chunked, single = ttrain.setup_zoo(name, args, "cpu"), ttrain.setup_zoo(name, args, "cpu")
    step = tzoo.make_zoo_train_step(single.method, single.model, single.config,
                                    single.optimizer)
    grids = []
    for start in (1, chunk + 1):
        if chunked.occupancy is not None and ttrain.occupancy_update_due(start, chunk):
            grids.append(start)
            chunked.update_grid()
        want = chunked.run_chunk()
        for s in range(start, start + chunk):
            if single.occupancy is not None and ttrain.occupancy_update_due(s):
                single.update_grid()
            rows = torch.from_numpy(single.optimizer.block_scalars(1))
            got = step(single.cameras, single.sample(), single.generator, single.occupancy,
                       scalars=rows[0])
            single.optimizer.advance(1)
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    _assert_same_state(_state(chunked), _state(single))
    assert chunked.run_chunk.steps_by_dispatch == {"eager": 2 * chunk, "captured": 0,
                                                   "replayed": 0}
    assert grids == ([warmup + 1] if chunked.occupancy is not None else [])
    assert chunked.optimizer.count == 2 * chunk


def _main(name, scene, out, steps, capsys, extra=()):
    runs, callbacks = [], []
    rc = ttrain.main([name, "--data", str(scene), "--max-num-iterations", str(steps),
                      "--rays-per-batch", str(RAYS), "--output-dir", str(out), *extra],
                     device="cpu", step_callback=lambda s, m: callbacks.append(
                         (s, {k: float(v) for k, v in m.items()})),
                     run_callback=runs.append)
    assert rc == 0
    return runs[0], callbacks, capsys.readouterr().out


def test_train_main_in_chunks_equals_chunks_of_one(scene, tmp_path, monkeypatch, capsys):
    """instant-ngp for 32 steps with the grid warm-up at 16: in its chunks
    of 16 (two callbacks) and with ``dispatch_chunk`` 1 (32 callbacks),
    the same model, grid updates and last metrics bit for bit."""
    tiny_configs(monkeypatch)
    monkeypatch.setattr(ttrain, "OCC_WARMUP", 16)
    chunked, calls, _ = _main("instant-ngp", scene, tmp_path / "a", 32, capsys)
    methods = tzoo.zoo_methods()
    methods["instant-ngp"].dispatch_chunk = 1
    monkeypatch.setattr(tzoo, "zoo_methods", lambda: methods)
    single, single_calls, _ = _main("instant-ngp", scene, tmp_path / "b", 32, capsys)
    assert [s for s, _ in calls] == [16, 32] and [s for s, _ in single_calls] == \
        list(range(1, 33))
    # the grid's occupied share comes with the callback after its update:
    # the chunk from step 17, or step 17
    last = dict(calls[-1][1])
    assert last.pop("occupied") == single_calls[16][1]["occupied"]
    assert last == single_calls[-1][1]
    assert chunked.occupancy_updates == single.occupancy_updates and \
        [s for s, _ in chunked.occupancy_updates] == [17]
    a, b = chunked.model.state_dict(), single.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(chunked.occupancy, single.occupancy)


def _jax_cadence(name, scene, steps, monkeypatch, capsys):
    """JAX's ``train_zoo`` with its chunk a no-op: (the steps it logs, the
    steps its grid is updated before).  The grid updates are read from its
    host loop's ``fold_in(fold_in(PRNGKey(seed), 0x0CC), start)``."""
    import functools

    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from samnerf_tpu import train as jtrain
    from samnerf_tpu.configs import zoo as jzoo
    from samnerf_tpu.models import instant_ngp as jngp, nerfplayer as jnp_model

    monkeypatch.setattr(jngp, "InstantNGPConfig", functools.partial(
        jngp.InstantNGPConfig, num_samples=8, num_levels=2, max_res=32,
        log2_hashmap_size=10))
    monkeypatch.setattr(jnp_model, "NerfPlayerConfig", functools.partial(
        jnp_model.NerfPlayerConfig, num_samples=8, num_levels=2, max_res=32,
        log2_hashmap_size=10, num_time_steps=2, hidden_dim=8))

    def chunk_stub(method, model, config, optimizer):
        def chunk_fn(params, opt_state, cameras, batches, rngs, occupancy=None):
            return params, opt_state, {"total_loss": jnp.float32(0.5)}
        return chunk_fn

    monkeypatch.setattr(jzoo, "make_zoo_train_chunk", chunk_stub)

    class Checkpointer:
        def save(self, path, params):
            pass

        def wait_until_finished(self):
            pass

    monkeypatch.setattr(ocp, "StandardCheckpointer", Checkpointer)
    folds, fold_in = [], jax.random.fold_in

    def recording_fold_in(key, data):
        if not isinstance(key, jax.core.Tracer):
            folds.append(int(data))
        return fold_in(key, data)

    monkeypatch.setattr(jax.random, "fold_in", recording_fold_in)
    capsys.readouterr()
    assert jtrain.train_zoo(name, ["--data", str(scene), "--max-num-iterations", str(steps),
                                   "--rays-per-batch", str(RAYS),
                                   "--output-dir", str(scene.parent / "jax_out")]) == 0
    monkeypatch.setattr(jax.random, "fold_in", fold_in)
    logs = [int(s) for s in LOG_LINE.findall(capsys.readouterr().out)]
    updates = [folds[i + 1] for i, d in enumerate(folds[:-1]) if d == 0x0CC]
    return logs, updates


@pytest.mark.parametrize("steps", [20, 300])
@pytest.mark.parametrize("name", ["instant-ngp", "nerfplayer-ngp"])
def test_chunk_cadence_matches_jax(name, steps, scene, tmp_path, monkeypatch, capsys):
    logs, updates = _jax_cadence(name, scene, steps, monkeypatch, capsys)
    tiny_configs(monkeypatch)

    def chunk_stub(method, model, config, optimizer, cameras, sample, generator, chunk,
                   occupancy=None):
        def run():
            run.steps_by_dispatch["eager"] += chunk
            return {"total_loss": torch.tensor(0.5)}
        run.steps_by_dispatch = {"eager": 0, "captured": 0, "replayed": 0}
        return run

    monkeypatch.setattr(tzoo, "make_zoo_train_chunk", chunk_stub)
    run, calls, out = _main(name, scene, tmp_path / "out", steps, capsys)
    chunk = tzoo.zoo_methods()[name].dispatch_chunk
    rounded = -(-steps // chunk) * chunk
    assert [int(s) for s in LOG_LINE.findall(out)] == logs and logs[-1] == rounded
    assert [s for s, _ in run.occupancy_updates] == updates
    assert [s for s, _ in calls] == list(range(chunk, rounded + 1, chunk))
    assert run.steps_by_dispatch["eager"] == rounded
    assert torch.load(run.checkpoint, weights_only=True)["step"] == rounded
    if steps == 300:
        assert updates == [257, 273, 289]
    else:
        assert updates == [] and logs == [rounded]
    assert np.isfinite(run.psnr)
