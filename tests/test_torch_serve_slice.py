"""The port's serve slice as a whole against the JAX package, on the CPU:
the same weights render one 64x64 frame of the tiny model through
``SamNerfRenderer`` (static preset, chunk 1024, morton hash) in both
packages, and one click decodes a mask on the rendered SAM embedding.

Mirrors ``tests/test_render_pipeline.py::test_serve_frame_fn_device_fast_path``.
Tolerances: rgb / SAM / ClipSeg grids atol 1e-4 (float32 sums in another
order through proposal sampling, three MLPs and the conv head); the
decoded mask agrees on >= 99.9 % of pixels (a logit near 0 may flip); the
uint8 frames differ by at most 1 away from flipped mask pixels.

Top-k ties: ``torch.topk`` and ``lax.top_k`` may order equal weights
differently, but equal weights that both packages could pick differently
are zero weights (empty space, or samples past full opacity).  They
contribute nothing after sharpening, and their samples take the sentinel
position, so tie order cannot change a grid.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from samnerf_tpu.core.cameras import Cameras as JaxCameras
from samnerf_tpu.engine.render_pipeline import SamNerfRenderer as JaxRenderer
from samnerf_tpu.models.sam_model import SAMModel as JaxModel
from samnerf_tpu.ops.hash_pallas import bake_quantized_tables
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.perception.sam.sam import Sam

from test_model import TINY, make_bundle
from test_torch_convert import decoder_state, port_config

H = W = 64
CLICK = (20.0, 37.0)
C2W = np.array([[1, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.3]], np.float32)


def _model_params(cfg, seed=0):
    """Flax params of ``cfg`` drawn with numpy: tables U(-0.5, 0.5), dense
    and conv kernels N(0, 1/fan_in), biases N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: JaxModel(cfg).init(
        jax.random.PRNGKey(0), make_bundle(16), rng=jax.random.PRNGKey(1),
        train=False, get_features=("sam", "clipseg")))
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


def run_both(q8: bool, fuse: bool = False):
    """(JAX outputs, port outputs): dicts of rgb / sam / clipseg grids, the
    uint8 frame and the mask, as numpy.  ``fuse``: baked int8 tables (JAX's
    ``bake_quantized_tables``, carried over by the converter) served with
    ``serve_fuse_mlp``."""
    cfg = dataclasses.replace(TINY, hash_fn="morton", hash_q8_serve=q8,
                              serve_fuse_mlp=fuse)
    params = _model_params(cfg)
    if fuse:
        params = jax.tree.map(np.asarray, bake_quantized_tables(params, optimize=12))
    dec_sd = decoder_state(3, for_masks=True)

    jsam, _ = build_sam("vit_b")
    jdec = {"params": convert_torch_state_dict(dec_sd, depth=12)}
    jcams = JaxCameras(camera_to_worlds=jnp.asarray(C2W[None]),
                       fx=jnp.asarray([[40.0]]), fy=jnp.asarray([[40.0]]),
                       cx=jnp.asarray([[W / 2.0]]), cy=jnp.asarray([[H / 2.0]]),
                       width=W, height=H)
    jsnr = JaxRenderer(JaxModel(cfg), chunk=1024, serve_preset="static")
    jgrids = jsnr.renderer.render_image_device(params, jcams, 0, W, H,
                                               features=("sam", "clipseg"),
                                               minimal=True)
    jimg, jmask = jsnr.serve_frame_fn(jsam, jdec, H, W)(params, jcams, 0, CLICK,
                                                        return_mask=True)
    ref = {k: np.asarray(v) for k, v in jgrids.items()}
    ref.update(img=np.asarray(jimg), mask=np.asarray(jmask))

    tcfg = port_config(cfg)
    model = SAMModel(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    sam = Sam(device="cpu")
    sam.load_state_dict(dec_sd)
    cams = Cameras(camera_to_worlds=torch.from_numpy(C2W[None]),
                   fx=torch.tensor([[40.0]]), fy=torch.tensor([[40.0]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H)
    snr = SamNerfRenderer(model, chunk=1024, serve_preset="static")
    grids = snr.renderer.render_image_device(cams, 0, W, H, ("sam", "clipseg"),
                                             minimal=True)
    img, mask = snr.serve_frame_fn(sam, H, W)(cams, 0, CLICK, return_mask=True)
    out = {k: v.numpy() for k, v in grids.items()}
    out.update(img=img.numpy(), mask=mask.numpy())
    return ref, out


def check_frame(ref, out):
    for k, shape in (("rgb", (H, W, 3)), ("sam", (64, 64, 256)),
                     ("clipseg", (32, 32, 192))):
        assert out[k].shape == ref[k].shape == shape, k
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    assert out["img"].dtype == np.uint8 and out["img"].shape == (H, W, 3)
    # the click must decode a real mask, not an all-or-nothing one
    assert 0.01 < ref["mask"].mean() < 0.99
    same = out["mask"] == ref["mask"]
    assert same.mean() >= 0.999
    diff = np.abs(out["img"].astype(int) - ref["img"].astype(int))
    assert diff[same].max() <= 1


def test_serve_frame_matches_jax_f32_tables():
    check_frame(*run_both(q8=False))
