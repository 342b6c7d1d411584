"""FUSED-QMLP and the fused serve fields of the port against the JAX
package, on the CPU.

The port's ``parity_hash_encode_qmlp`` runs its plain version on CPU
tensors; JAX's runs its TPU kernel in interpret mode (``pl.pallas_call``
and ``jax.default_backend`` monkeypatched, as ``tests/test_hash_pallas.py``
runs it) and its CPU fallback.  Tolerance rtol 1e-4 / atol 1e-4, the JAX
kernel test's own: the MLP sums in f32 in other orders.  The fused fields
(``hash_q8=True, fuse_mlp=True``) run JAX's fallback, on the same weights
through ``convert.params_from_jax``, and equal the port's own unfused
int8 fields (rtol 1e-5 / atol 1e-6: ``addmm`` against ``matmul`` + add).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from samnerf_tpu.fields.nerfacto_field import HashMLPDensityField as JaxDensityField
from samnerf_tpu.fields.nerfacto_field import NerfactoField as JaxNerfactoField
from samnerf_tpu.fields.sam_field import SAMField as JaxSAMField
from samnerf_tpu.ops import hash_pallas as hp
from samnerf_tpu.ops.encodings import hash_grid_scalings
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.fields.nerfacto_field import HashMLPDensityField, NerfactoField
from samnerf_tpu_torch.fields.sam_field import SAMField
from samnerf_tpu_torch.ops import hash_grid as th

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramids(stacked: bool, qbits: int, steps: int = 4, n: int = 256, seed: int = 0):
    """Packed tables (JAX's packing), scales, scalings and positions of one
    pyramid (3 levels, 2 packs, res 4..64) or two with other scalings
    (res 8..128), as the SAM head stacks them."""
    rng = np.random.default_rng(seed)
    res = [(4, 64), (8, 128)][:2 if stacked else 1]
    packed, scales, scalings = [], [], []
    for lo, hi in res:
        table = rng.uniform(-0.5, 0.5, (2 * 3, steps * 8, 128, 2)).astype(np.float32)
        pk, sc = hp.quantize_parity_table(jnp.asarray(table), qbits=qbits)
        packed.append(np.asarray(pk))
        scales.append(np.asarray(sc))
        scalings.append(tuple(hash_grid_scalings(3, lo, hi).tolist()))
    pos = rng.uniform(0.001, 0.999, (n, 3)).astype(np.float32)
    return packed, scales, scalings, pos


def _serve(packed):
    """The serve layout the wrappers take, of 3-level packed tables."""
    return [th.interleave_packs(_t(p), 3) for p in packed]


def _mlp(rng, c, h, o):
    return [(rng.normal(size=s) * f).astype(np.float32)
            for s, f in (((c, h), 0.2), ((h,), 0.1), ((h, o), 0.2), ((o,), 0.1))]


@pytest.mark.parametrize("hash_fn", ("reference", "morton"))
@pytest.mark.parametrize("qbits", (8, 4))
@pytest.mark.parametrize("stacked", (False, True))
def test_plain_qmlp_matches_jax(monkeypatch, stacked, qbits, hash_fn):
    packed, scales, scalings, pos = _pyramids(stacked, qbits)
    c = sum(2 * p.shape[0] for p in packed)
    w = _mlp(np.random.default_rng(1), c, 32, 9)
    jargs = ([jnp.asarray(p) for p in packed], [jnp.asarray(s) for s in scales],
             jnp.asarray(pos), scalings, 4, *map(jnp.asarray, w))
    fallback = np.asarray(hp.parity_hash_encode_qmlp(*jargs, hash_fn=hash_fn, qbits=qbits))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    kernel = np.asarray(hp.parity_hash_encode_qmlp(*jargs, hash_fn=hash_fn, qbits=qbits))
    out = th.parity_hash_encode_qmlp(_serve(packed), [_t(s) for s in scales],
                                     _t(pos), scalings, 4, *map(_t, w),
                                     hash_fn=hash_fn, qbits=qbits)
    assert out.shape == (256, 9)
    np.testing.assert_allclose(out.numpy(), kernel, **TOL)
    np.testing.assert_allclose(out.numpy(), fallback, **TOL)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    packed, scales, scalings, pos = _pyramids(True, 8)
    w = [_t(a) for a in _mlp(np.random.default_rng(2), 24, 16, 5)]
    args = ([_t(s) for s in scales], _t(pos), scalings, 4, *w)
    before = th.parity_hash_encode_qmlp.launches
    out = th.parity_hash_encode_qmlp(_serve(packed), *args, hash_fn="morton")
    ref = th._parity_hash_encode_qmlp_ref([_t(p) for p in packed], *args, hash_fn="morton")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert th.parity_hash_encode_qmlp.launches == before


@pytest.mark.parametrize("bad", ["steps", "qbits", "w1_rows", "chain", "strided",
                                 "dtype", "lists", "pyramids", "layout", "packs",
                                 "out_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    packed, scales, scalings, pos = _pyramids(True, 8)
    packed, scales, pos = _serve(packed), [_t(s) for s in scales], _t(pos)
    w1, b1, w2, b2 = (_t(a) for a in _mlp(np.random.default_rng(3), 24, 16, 5))
    steps, qbits = 4, 8
    if bad == "steps":          # a pyramid packed at another table size
        packed[1] = _t(np.zeros((3, 32, 128, 2), np.float32))
    elif bad == "layout":       # the packed (checkpoint) layout
        packed[0] = th.deinterleave_packs(packed[0])
    elif bad == "packs":        # 3 packs (6 features per level)
        packed[0] = _t(np.zeros((3, 16, 128, 3), np.float32))
        scales[0] = _t(np.zeros(9, np.float32))
    elif bad == "out_dim":
        w2, b2 = torch.zeros((16, 257)), torch.zeros(257)
    elif bad == "qbits":        # q8 packing read as q4
        qbits = 4
    elif bad == "w1_rows":
        w1 = w1[:20].contiguous()
    elif bad == "chain":
        w2 = torch.zeros((15, 5))
    elif bad == "strided":
        w1 = w1.t().contiguous().t()
    elif bad == "dtype":
        b2 = b2.double()
    elif bad == "lists":
        scales = scales[:1]
    else:
        packed, scales, scalings = packed * 3, scales * 3, scalings * 3
    with pytest.raises(ValueError):
        th.parity_hash_encode_qmlp(packed, scales, pos, scalings, steps, w1, b1, w2, b2,
                                   qbits=qbits)


# --- the fused fields ----------------------------------------------------------------

NERFACTO = dict(num_levels=4, max_res=64, log2_hashmap_size=12, hidden_dim=16,
                hidden_dim_color=16, geo_feat_dim=7)
PROPOSAL = dict(num_levels=3, max_res=32, log2_hashmap_size=11, hidden_dim=8)
SAM = dict(grid_layers=(2, 3), grid_sizes=(12, 12),
           grid_resolutions=((8, 32), (32, 64)), hidden_dim=32, sam_dim=24,
           clipseg_dim=12)


def _draw(shapes, seed):
    """Flax params drawn with numpy: tables U(-0.5, 0.5), kernels
    N(0, 1/fan_in), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "table" in name:
            return rng.uniform(-0.5, 0.5, s.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        return (rng.normal(0.0, 1.0, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _positions(seed, r=24, s=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (r, s, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3))
    return pos, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _port(cls, kw, params, fuse, qbits):
    field = cls(hash_q8=True, fuse_mlp=fuse, hash_fn="morton", quant_bits=qbits,
                device="cpu", **kw)
    field.load_state_dict(params_from_jax(params))
    return field


@pytest.mark.parametrize("qbits", (8, 4))
def test_fused_nerfacto_field_matches_jax(qbits):
    pos, dirs = _positions(4)
    kw = dict(hash_q8=True, fuse_mlp=True, hash_fn="morton", quant_bits=qbits)
    jfield = JaxNerfactoField(**NERFACTO, **kw)
    params = _draw(jax.eval_shape(lambda: jfield.init(
        jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(dirs))), 5)
    ref = jfield.apply(params, jnp.asarray(pos), jnp.asarray(dirs), train=False)
    outs = {}
    for fuse in (True, False):
        field = _port(NerfactoField, NERFACTO, params, fuse, qbits)
        with torch.no_grad():
            outs[fuse] = field(_t(pos), _t(dirs))
    for k in ("density", "rgb"):
        np.testing.assert_allclose(outs[True][k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(outs[True][k].numpy(), outs[False][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("qbits", (8, 4))
def test_fused_proposal_field_matches_jax(qbits):
    pos, _ = _positions(6)
    jfield = JaxDensityField(**PROPOSAL, hash_q8=True, fuse_mlp=True, hash_fn="morton",
                             quant_bits=qbits)
    params = _draw(jax.eval_shape(lambda: jfield.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(pos))), 7)
    ref = np.asarray(jfield.apply(params, jnp.asarray(pos)))
    outs = {}
    for fuse in (True, False):
        with torch.no_grad():
            outs[fuse] = _port(HashMLPDensityField, PROPOSAL, params, fuse, qbits)(
                _t(pos)).numpy()
    np.testing.assert_allclose(outs[True], ref, **TOL)
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("baked", (False, True))
def test_fused_sam_field_matches_jax(baked):
    """Both heads stack two pyramids of different scalings; a live mask
    moves culled samples to the sentinel before the fused call; ``baked``
    reads the MSE-optimal int8 tables of ``bake_quantized_tables``."""
    pos, _ = _positions(8)
    live = (np.random.default_rng(9).uniform(size=(24, 5, 1)) > 0.3).astype(np.float32)
    jfield = JaxSAMField(**SAM, hash_q8=True, fuse_mlp=True, hash_fn="morton")
    params = _draw(jax.eval_shape(lambda: jfield.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(pos))), 10)
    if baked:
        params = jax.tree.map(np.asarray, hp.bake_quantized_tables(params, optimize=12))
    ref = jfield.apply(params, jnp.asarray(pos), ("sam", "clipseg"), jnp.asarray(live))
    outs = {}
    for fuse in (True, False):
        with torch.no_grad():
            outs[fuse] = _port(SAMField, SAM, params, fuse, 8)(
                _t(pos), ("sam", "clipseg"), _t(live))
    for k, width in (("sam", 24), ("clipseg", 12)):
        assert outs[True][k].shape == (24, 5, width)
        np.testing.assert_allclose(outs[True][k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(outs[True][k].numpy(), outs[False][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sam_field_fuses_only_pyramids_of_one_table_size():
    kw = dict(SAM, grid_sizes=(12, 11))
    assert not SAMField(hash_q8=True, fuse_mlp=True, device="meta", **kw).fuse
    assert SAMField(hash_q8=True, fuse_mlp=True, device="meta", **SAM).fuse
    assert not SAMField(hash_q8=False, fuse_mlp=True, device="meta", **SAM).fuse
