"""Weights carried from the JAX package into the port
(samnerf_tpu_torch.convert.params_from_jax), and the modules that run on
them, against their flax counterparts on the CPU (rtol 1e-5 / atol 1e-5:
float32 sums taken in another order)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.fields.hash_encoding import ParityHashEncoding as JaxEncoding
from samnerf_tpu.fields.mlp import MLP as JaxMLP
from samnerf_tpu.fields.sam_field import ConvHead as JaxConvHead
from samnerf_tpu.ops.hash_pallas import bake_quantized_tables
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu.perception.sam.sam import Sam as JaxSam
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.fields.mlp import MLP
from samnerf_tpu_torch.fields.sam_field import ConvHead
from samnerf_tpu_torch.models.sam_model import SAMModelConfig
from samnerf_tpu_torch.perception.sam.sam import Sam


def port_config(cfg) -> SAMModelConfig:
    """The port's config with the JAX config's values; its
    ``compute_dtype`` (a jnp type) by name."""
    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SAMModelConfig)}
    values["compute_dtype"] = np.dtype(cfg.compute_dtype).name
    return SAMModelConfig(**values)


def decoder_state(seed: int = 0, for_masks: bool = False):
    """A reference-named torch state dict for SAM's prompt encoder and mask
    decoder, drawn with numpy: weights N(0, 1/fan_in), biases N(0, 0.02),
    norm weights 1.  ``for_masks`` makes random weights decode masks with
    a boundary inside a frame: each ConvTranspose gets one kernel at its
    four taps (no 2x2 checkerboard), and the image-to-token attention's
    query and key projections are scaled 4x (its logits 16x) so the image
    positional encoding shapes the mask logits."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, ref in Sam(device="meta").state_dict().items():
        shape = tuple(ref.shape)
        if name.endswith("bias"):
            v = rng.normal(0.0, 0.02, shape)
        elif len(shape) == 1:
            v = np.ones(shape)
        else:
            v = rng.normal(0.0, 1.0, shape) / np.sqrt(np.prod(shape[1:]))
        if for_masks and "output_upscaling" in name and len(shape) == 4:
            v = np.broadcast_to(v[:, :, :1, :1], shape)
        if for_masks and "cross_attn_image_to_token" in name and (
                "q_proj.weight" in name or "k_proj.weight" in name):
            v = v * 4.0
        state[name] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return state


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_decoder_weights_round_trip_exactly():
    sd = decoder_state()
    flax_tree = _np_tree(convert_torch_state_dict(sd, depth=12))
    back = params_from_jax({"params": flax_tree})
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("mode", ("f32", "q8", "q4", "q8_baked"))
def test_parity_hash_encoding_forward(mode):
    rng = np.random.default_rng(1)
    kw = dict(num_levels=4, min_res=8, max_res=256, log2_hashmap_size=12,
              features_per_level=4, hash_fn="morton",
              quantize_serve=mode != "f32", quant_bits=4 if mode == "q4" else 8)
    table = rng.uniform(-0.5, 0.5, (8, 4 * 8, 128, 2)).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (300, 3)).astype(np.float32)   # padded to 384
    params = {"table": table}
    if mode == "q8_baked":
        params = _np_tree(bake_quantized_tables({"table": jnp.asarray(table)},
                                                optimize=12))
    ref = JaxEncoding(**kw).apply({"params": params}, jnp.asarray(pos))
    enc = ParityHashEncoding(device="cpu", **kw)
    enc.load_state_dict(params_from_jax(params))
    out = enc(torch.from_numpy(pos))
    assert out.shape == (300, 16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_mlp_forward():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 24)).astype(np.float32)
    flax_mlp = JaxMLP(hidden_dim=32, num_hidden_layers=2, out_dim=5,
                      output_activation=jax.nn.sigmoid)
    params = _np_tree(flax_mlp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    mlp = MLP(24, 32, 2, 5, output_activation=torch.sigmoid, device="cpu")
    mlp.load_state_dict(params_from_jax(params))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(flax_mlp.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_conv_head_forward():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 4, 4, 256)).astype(np.float32)
    head = JaxConvHead()
    params = _np_tree(head.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    conv = ConvHead(device="cpu")
    conv.load_state_dict(params_from_jax(params))
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(head.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_mask_decoder_forward():
    """Prompt encoder + mask decoder on one embedding, a click padded with
    label -1 to four points, single- and multi-mask outputs."""
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(1, 64, 64, 256)).astype(np.float32)
    pts = np.zeros((1, 4, 2), np.float32)
    pts[0, :2] = [[300.0, 500.0], [700.0, 120.0]]
    labels = np.array([[1, 0, -1, -1]])
    sd = decoder_state(5)
    jsam, _ = build_sam("vit_b")
    jparams = {"params": convert_torch_state_dict(sd, depth=12)}
    sam = Sam(device="cpu")
    sam.load_state_dict(params_from_jax(_np_tree(jparams)))
    for multimask in (False, True):
        ref_m, ref_iou = jsam.apply(
            jparams, jnp.asarray(feat), (jnp.asarray(pts), jnp.asarray(labels)),
            None, None, multimask, method=JaxSam.decode_masks)
        m, iou = sam.decode_masks(torch.from_numpy(feat),
                                  (torch.from_numpy(pts), torch.from_numpy(labels)),
                                  multimask_output=multimask)
        assert m.shape == ref_m.shape == (1, 3 if multimask else 1, 256, 256)
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(iou.numpy(), np.asarray(ref_iou), rtol=1e-5,
                                   atol=1e-5)


def test_fused_serve_model_loads_converted_weights_strictly():
    """``serve_fuse_mlp`` adds no weights: a converted JAX tree of a fused
    int8 model, baked tables included, loads strictly into the port's."""
    from samnerf_tpu.models.sam_model import SAMModel as JaxModel
    from samnerf_tpu_torch.models.sam_model import SAMModel

    from test_model import TINY, make_bundle

    cfg = dataclasses.replace(TINY, hash_q8_serve=True, serve_fuse_mlp=True)
    shapes = jax.eval_shape(lambda: JaxModel(cfg).init(
        jax.random.PRNGKey(0), make_bundle(16), rng=jax.random.PRNGKey(1),
        train=False, get_features=("sam", "clipseg")))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = _np_tree(bake_quantized_tables(params, optimize=0))
    model = SAMModel(port_config(cfg), device="cpu")
    state = params_from_jax(params)
    model.load_state_dict(state, strict=True)
    assert set(model.state_dict()) == set(state)


def test_baked_serve_tables_keep_the_checkpoint_layout():
    """Baked tables stay in the packed layout in the state dict, beside a
    non-persistent serve-layout copy (``qserve{b}``, ``interleave_packs``
    of the table): JAX's baked tables load strictly, come back out of the
    state dict bit for bit, and ``bake_serve_tables`` on the same masters
    gives the same keys and the same bits."""
    from samnerf_tpu.models.sam_model import SAMModel as JaxModel
    from samnerf_tpu_torch.engine.render_pipeline import SamNerfRenderer
    from samnerf_tpu_torch.models.sam_model import SAMModel
    from samnerf_tpu_torch.ops.hash_grid import interleave_packs

    from test_model import TINY, make_bundle

    cfg = dataclasses.replace(TINY, hash_q8_serve=True, serve_fuse_mlp=True)
    shapes = jax.eval_shape(lambda: JaxModel(cfg).init(
        jax.random.PRNGKey(0), make_bundle(16), rng=jax.random.PRNGKey(1),
        train=False, get_features=("sam", "clipseg")))
    rng = np.random.default_rng(11)
    masters = jax.tree.map(lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(s.dtype), shapes)
    baked = _np_tree(bake_quantized_tables(masters, optimize=0))
    port_cfg = port_config(cfg)

    def words(t):
        return t.view(torch.int32)

    loaded = SAMModel(port_cfg, device="cpu")
    state = params_from_jax(baked)
    loaded.load_state_dict(state, strict=True)
    assert set(loaded.state_dict()) == set(state)
    assert not any("qserve" in k for k in state)
    for k, v in loaded.state_dict().items():
        assert torch.equal(words(v), words(state[k])), k
    own = SAMModel(port_cfg, device="cpu")
    own.load_state_dict(params_from_jax(_np_tree(masters)), strict=True)
    SamNerfRenderer(own).bake_serve_tables(optimize=0)
    own_state = own.state_dict()
    assert set(own_state) == set(state)
    encs = {n: m for n, m in own.named_modules() if isinstance(m, ParityHashEncoding)}
    assert {n for n, m in loaded.named_modules() if isinstance(m, ParityHashEncoding)} \
        == set(encs)
    for name, enc in loaded.named_modules():
        if not isinstance(enc, ParityHashEncoding):
            continue
        for b in (8, 4):
            for key in (f"qtable{b}", f"qscales{b}"):
                assert torch.equal(words(own_state[f"{name}.{key}"]),
                                   words(state[f"{name}.{key}"])), (name, key)
            for m in (enc, encs[name]):
                serve = getattr(m, f"qserve{b}")
                assert serve.shape[-1] == m.table.shape[0] // m.num_levels
                assert torch.equal(words(serve), words(interleave_packs(
                    getattr(m, f"qtable{b}"), m.num_levels)))
