"""The port's ``Trainer`` data-parallel over ``torch.distributed`` (gloo,
2 ranks spawned on the CPU) against one process.

``Trainer`` for 3 steps on a synthetic scene over 2 ranks (the main rank
evaluating every step from its own generator) against one process: every
step's losses at rtol 2e-3 (the ranks drew the one process's batches:
other batches move the losses by 10 %; the Adam noise below moves step
3's SAM loss by 8e-4), every parameter within 2 lr per step (Adam
amplifies the reduction-order noise of near-zero gradients step by step),
the ranks equal bit for bit, the checkpoint written by rank 0 alone; a
batch whose patches the ranks do not divide raises ValueError.
"""
import dataclasses

import numpy as np
import pytest

from samnerf_tpu_torch.utils import synthetic

import torch_dist_workers as workers
from test_torch_dist import GROUPS, LR
from test_torch_serve_slice import port_config
from test_torch_train_step import CFG


def test_trainer_two_ranks_match_one_process(tmp_path):
    scene = synthetic.write_scene(tmp_path / "scene", num_train=3, num_test=1, h=32, w=32,
                                  with_features=True, feature_long_side=8)
    cfg = port_config(dataclasses.replace(CFG, hash_fn="morton"))
    payload = {"cfg": cfg, "scene": str(scene), "rays": 64, "steps": 3, "eval_every": 1,
               "groups": GROUPS, "out": str(tmp_path / "dp")}
    two = workers.run_ranks("trainer_run", payload)
    one = workers.trainer_run(dict(payload, eval_every=0, out=str(tmp_path / "one")))
    assert two[0]["step"] == two[1]["step"] == one["step"] == 3
    assert two[0]["checkpoints"] == ["step-000000003.pt"] and two[1]["checkpoints"] == []
    for k in two[0]["params"]:
        np.testing.assert_array_equal(two[0]["params"][k], two[1]["params"][k], err_msg=k)
        assert np.abs(two[0]["params"][k] - one["params"][k]).max() <= 2 * LR * 3, k
    assert len(one["losses"]) == len(two[0]["losses"]) == 3
    for mine, ref in zip(two[0]["losses"], one["losses"]):
        for k, v in ref.items():
            np.testing.assert_allclose(mine[k], v, rtol=2e-3, err_msg=k)
    with pytest.raises(RuntimeError, match="do not split over 2 ranks"):
        workers.run_ranks("trainer_run", dict(payload, rays=36, out=str(tmp_path / "bad")))
