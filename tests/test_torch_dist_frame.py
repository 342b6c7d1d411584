"""The port's ``build_sharded_frame_fn`` over ``torch.distributed`` (gloo,
2 ranks spawned on the CPU) against the JAX package's.

``build_sharded_frame_fn`` over 2 ranks with a SAM decode against the
JAX ``build_sharded_frame_fn`` on ``make_mesh(2)`` (the tolerances of
``test_torch_serve_slice.py``: grids atol 1e-4, the mask on >= 99.9 % of
pixels) and against the port's own single-process frame, bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from samnerf_tpu.core.cameras import Cameras as JaxCameras
from samnerf_tpu.engine import eval_render as jer
from samnerf_tpu.engine.render_pipeline import SamNerfRenderer as JaxRenderer
from samnerf_tpu.models import sam_model as jm
from samnerf_tpu.parallel import mesh as jmesh
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu_torch.convert import params_from_jax

import torch_dist_workers as workers
from test_torch_convert import decoder_state
from test_torch_serve_slice import _model_params, port_config
from test_torch_train_step import CFG


FRAME_H = FRAME_W = 64
CLICK = (20.0, 37.0)


def test_sharded_frame_two_ranks_matches_jax(monkeypatch):
    assert len(jax.devices()) >= 2
    cfg = dataclasses.replace(CFG, hash_fn="morton")
    params = _model_params(cfg)
    dec_sd = decoder_state(3, for_masks=True)
    c2w = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.3]], np.float32)
    cams = {"camera_to_worlds": c2w[None], "fx": np.array([[40.0]], np.float32),
            "fy": np.array([[40.0]], np.float32),
            "cx": np.array([[FRAME_W / 2.0]], np.float32),
            "cy": np.array([[FRAME_H / 2.0]], np.float32)}
    size = {"width": FRAME_W, "height": FRAME_H}
    scale = 1024.0 / max(FRAME_H, FRAME_W)
    coords = np.zeros((1, 4, 2), np.float32)
    coords[0, 0] = [CLICK[0] * scale, CLICK[1] * scale]
    labels = np.full((1, 4), -1, np.int32)
    labels[0, 0] = 1

    jsam, _ = build_sam("vit_b")
    jdec = {"params": convert_torch_state_dict(dec_sd, depth=12)}
    jsnr = JaxRenderer(jm.SAMModel(cfg), chunk=1024, serve_preset="static")
    jframe = jer.build_sharded_frame_fn(jsnr.renderer, jmesh.make_mesh(2), FRAME_H,
                                        FRAME_W, features=("sam", "clipseg"), sam=jsam)
    ref = jframe(params, jdec, JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()},
                                          **size), 0, jnp.asarray(coords),
                 jnp.asarray(labels))
    ref = {k: np.asarray(v) for k, v in ref.items()}

    payload = {"cfg": port_config(cfg), "chunk": 1024, "cameras": cams, "size": size,
               "params": {k: v.numpy() for k, v in params_from_jax(params).items()},
               "decoder": {k: v.numpy() for k, v in dec_sd.items()},
               "coords": coords, "labels": labels}
    two = workers.run_ranks("sharded_frame", payload)
    one = workers.sharded_frame(payload)
    for k in ("rgb", "sam", "clipseg", "masked_rgb"):
        np.testing.assert_array_equal(two[0][k], two[1][k], err_msg=k)
        np.testing.assert_array_equal(two[0][k], one[k], err_msg=k)
    for k, shape in (("rgb", (FRAME_H, FRAME_W, 3)), ("sam", (64, 64, 256)),
                     ("clipseg", (32, 32, 192))):
        assert two[0][k].shape == ref[k].shape == shape, k
        np.testing.assert_allclose(two[0][k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    red = np.array([1.0, 0.0, 0.0], np.float32)
    overlay = lambda out: np.isclose(out["masked_rgb"],  # noqa: E731
                                     np.clip(0.5 * out["rgb"] + 0.5 * red, 0, 1)).all(-1)
    jmask, tmask = overlay(ref), overlay(two[0])
    assert 0.01 < jmask.mean() < 0.99
    assert (jmask == tmask).mean() >= 0.999
    same = jmask == tmask
    np.testing.assert_allclose(two[0]["masked_rgb"][same], ref["masked_rgb"][same], atol=1e-4)
