"""The data-parallel trainer's blocks and its gradient all-reduce over
``torch.distributed`` (gloo, 2 ranks spawned on the CPU, each with its
own timeout).  On the card each rank replays a block as one CUDA graph,
its collectives inside; here the same steps run eagerly, so these tests
hold what every rank replays.

- ``mesh.all_reduce_grads`` gives each rank the two ranks' f32 gradients
  summed and divided by 2, bit for bit, gradients spanning ten decades; a
  parameter without a gradient (the first, or one in the middle) keeps
  none on either rank.
- The tiny ``Trainer`` data-parallel over 10 steps with
  ``steps_per_dispatch=4`` (two blocks, then two single steps) against
  the same 10 eager data-parallel steps (``steps_per_dispatch=1``, the
  eager step updating through ``GroupedAdam.device_step`` as a block
  does; rank 0 evaluating from its own generator in both): the callbacks'
  metrics, the parameters, the Adam moments and the step counts bit for
  bit, and the two ranks' parameters and moments bit for bit.
- The callbacks, log rows, eval batches, eval images and checkpoints of
  the data-parallel blocked ``Trainer`` fire on rank 0 at the steps the
  single-process blocked ``Trainer``'s fire (the cadences of
  ``test_torch_dispatch.py``'s comparison with JAX); rank 1 evaluates and
  saves nothing.
"""
import numpy as np
import pytest

from samnerf_tpu_torch.data.datamanager import DataManagerConfig
from samnerf_tpu_torch.data.dataparser import DataparserConfig
from samnerf_tpu_torch.utils import synthetic

import torch_dist_workers as workers
from test_torch_train_slice import GROUPS, TINY

SHAPES = [(5,), (37,), (3, 2), (4, 16), (2,)]
CADENCES = dict(max_num_iterations=10, log_every=3, steps_per_eval_batch=5,
                steps_per_eval_image=7, steps_per_save=4)


@pytest.mark.parametrize("no_grad", [0, 2])
def test_all_reduce_grads_is_the_mean_of_the_ranks(no_grad):
    ranks = workers.run_ranks("all_reduce_grads", {"shapes": SHAPES, "no_grad": no_grad})
    for r in ranks:
        for i, got in enumerate(r["averaged"]):
            if i == no_grad:
                assert got is None
            else:
                want = (ranks[0]["mine"][i] + ranks[1]["mine"][i]) / np.float32(2)
                assert got.shape == want.shape == SHAPES[i] and got.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=str(i))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 ranks' blocked and eager runs, and one process's blocked run."""
    root = tmp_path_factory.mktemp("dist_block")
    scene = synthetic.write_scene(root / "scene", num_train=4, num_test=2, h=32, w=32,
                                  with_features=True, feature_long_side=8)
    dm = DataManagerConfig(dataparser=DataparserConfig(data=scene, train_val_json_split=True),
                           train_num_rays_per_batch=256, eval_num_rays_per_batch=256,
                           patch_size=2, distill_sam=True, use_clipseg_feature=True)
    payload = {"cfg": TINY, "groups": GROUPS, "dm": dm, "cadences": CADENCES,
               "out": str(root / "dp"), "blocks": (4, 1)}
    ranks = workers.run_ranks("dp_blocks", payload, timeout=150.0)
    single = workers.dp_blocks(dict(payload, out=str(root / "single"), blocks=(4,)))[4]
    return ranks, single


def test_data_parallel_blocks_are_the_eager_steps(runs):
    ranks, _ = runs
    for r in ranks:
        blocks, eager = r[4], r[1]
        assert blocks["steps_by_dispatch"] == {"eager": 10, "captured": 0, "replayed": 0}
        assert blocks["step"] == eager["step"] == 10
        assert blocks["count"] == eager["count"] == 10
        assert blocks["steps_since_update"] == eager["steps_since_update"]
        assert [s for s, _ in blocks["callback"]] == [4, 8, 9, 10]
        eager_metrics = dict(eager["callback"])
        assert sorted(eager_metrics) == list(range(1, 11))
        for step, m in blocks["callback"]:
            assert m == eager_metrics[step], step
        for k in blocks["params"]:
            np.testing.assert_array_equal(blocks["params"][k], eager["params"][k], err_msg=k)
        assert blocks["moments"].keys() == eager["moments"].keys()
        for k, (m, v) in blocks["moments"].items():
            np.testing.assert_array_equal(m, eager["moments"][k][0], err_msg=k)
            np.testing.assert_array_equal(v, eager["moments"][k][1], err_msg=k)


def test_data_parallel_ranks_agree(runs):
    ranks, _ = runs
    for block in (4, 1):
        a, b = ranks[0][block], ranks[1][block]
        assert a["callback"] == b["callback"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
        for k, (m, v) in a["moments"].items():
            np.testing.assert_array_equal(m, b["moments"][k][0], err_msg=k)
            np.testing.assert_array_equal(v, b["moments"][k][1], err_msg=k)


def test_data_parallel_cadences_are_the_single_process_ones(runs):
    ranks, single = runs
    main, other = ranks[0][4], ranks[1][4]
    for k in ("eval_batch", "eval_image", "save", "log"):
        assert main[k] == single[k], k
    assert [s for s, _ in main["callback"]] == [s for s, _ in single["callback"]]
    assert main["save"] == [4, 8] and main["eval_batch"] == [8, 10]
    assert main["eval_image"] == [8] and main["log"] == [4, 8, 9, 10]
    assert other["eval_batch"] == other["eval_image"] == [] and other["save"] == []
    assert other["log"] == main["log"]
