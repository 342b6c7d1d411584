"""The port's hash encode (samnerf_tpu_torch.ops.hash_grid) against the JAX
package's (samnerf_tpu.ops.hash_pallas), on the CPU.

The same numpy inputs go through both.  On the CPU the JAX public ops run
their ``*_ref`` paths and the port's wrappers run their plain versions;
the CUDA kernels are held against those plain versions on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).  Tolerances
are those of ``tests/test_hash_pallas.py`` (rtol 1e-5 / atol 1e-6); index
math and quantized packing are held to exact equality.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.ops import hash_pallas as hp
from samnerf_tpu.ops.encodings import hash_grid_scalings
from samnerf_tpu_torch.ops import hash_grid as th

HASH_FNS = ("reference", "morton", "morton6")
# (L, steps, min_res, max_res): the _setup shapes of test_hash_pallas.py,
# and a 64-step table whose two coarse levels are dense
SMALL, LARGE = (4, 4, 4, 64), (6, 64, 16, 512)
CASES = ([(h, p, SMALL) for h in HASH_FNS for p in (1, 4)]
         + [("reference", 1, LARGE), ("morton", 4, LARGE)])


def _inputs(L, steps, P, min_res, max_res, n=256, seed=0):
    scalings = tuple(hash_grid_scalings(L, min_res, max_res).tolist())
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (P * L, steps * 8, 128, 2)).astype(np.float32)
    pos = rng.uniform(0.001, 0.999, (n, 3)).astype(np.float32)
    return scalings, table, pos


def test_large_shape_has_dense_and_hashed_levels():
    scalings = hash_grid_scalings(6, 16, 512)
    dense = [d for _, d, _ in th._level_plan(scalings, 64)]
    assert dense[0] and not dense[-1]
    assert dense == [d for _, d, _ in hp._level_plan(scalings, 64)]


@pytest.mark.parametrize("hash_fn,P,shape", CASES)
def test_f32_encode_matches_jax(hash_fn, P, shape):
    L, steps, lo_res, hi_res = shape
    scalings, table, pos = _inputs(L, steps, P, lo_res, hi_res)
    ref = hp.parity_hash_encode(jnp.asarray(table), jnp.asarray(pos), scalings,
                                steps, 0, hash_fn)
    out = th.parity_hash_encode(torch.from_numpy(table), torch.from_numpy(pos),
                                scalings, steps, hash_fn)
    assert out.shape == (256, P * 2 * L)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hash_fn,P,shape", CASES)
@pytest.mark.parametrize("qbits", (8, 4))
def test_quantized_encode_matches_jax(qbits, hash_fn, P, shape):
    """The wrapper, given the serve layout, against JAX's public op and its
    plain version on the same packed tables."""
    L, steps, lo_res, hi_res = shape
    scalings, table, pos = _inputs(L, steps, P, lo_res, hi_res)
    packed, scales = hp.quantize_parity_table(jnp.asarray(table), qbits=qbits)
    ref = hp.parity_hash_encode_q8(packed, scales, jnp.asarray(pos), scalings,
                                   steps, hash_fn, qbits=qbits)
    plain = hp._parity_hash_encode_q8_ref(packed, scales, jnp.asarray(pos), scalings,
                                          steps, hash_fn, qbits=qbits)
    out = th.parity_hash_encode_q8(th.interleave_packs(torch.from_numpy(np.array(packed)), L),
                                   torch.from_numpy(np.array(scales)),
                                   torch.from_numpy(pos), scalings, steps,
                                   hash_fn, qbits=qbits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", (1, 2, 4))
@pytest.mark.parametrize("qbits", (8, 4))
def test_interleave_packs_is_an_exact_permutation(qbits, P):
    """[P*L, rows_q, 128] -> [L, rows_q, 128, P] and back, bit for bit,
    with word (l, r, lane, p) = packed word (p*L + l, r, lane); P = 3 is
    refused."""
    L = 3
    _, table, _ = _inputs(L, 8, P, 4, 64)
    packed, _ = th.quantize_parity_table(torch.from_numpy(table), qbits=qbits)
    inter = th.interleave_packs(packed, L)
    assert inter.shape == (L, packed.shape[1], 128, P) and inter.is_contiguous()
    words = packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        inter.numpy().view(np.uint32),
        words.reshape(P, L, *words.shape[1:]).transpose(1, 2, 3, 0))
    back = th.deinterleave_packs(inter)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), words)
    with pytest.raises(ValueError):
        th.interleave_packs(torch.zeros((3 * L, 8, 128)), L)


@pytest.mark.parametrize("P", (2, 4))
def test_pack_bf16_table_is_jax_pack_table_interleaved(P):
    """BF16-PACK's plain version: word (l, r, lane, p) is JAX's
    ``pack_table`` word of master row p*L + l, bit for bit, and unpacks
    (hi half feature 0, lo half feature 1) to the table at bf16 precision;
    1 and 3 packs are refused."""
    L = 3
    _, table, _ = _inputs(L, 8, P, 4, 64)
    table[0, 0, 0] = (1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8))     # ties round to even
    inter = th.pack_bf16_table(torch.from_numpy(table), L)
    assert inter.shape == (L, 64, 128, P) and inter.is_contiguous()
    words = np.asarray(hp.pack_table(jnp.asarray(table))).view(np.uint32)
    np.testing.assert_array_equal(
        inter.numpy().view(np.uint32),
        words.reshape(P, L, *words.shape[1:]).transpose(1, 2, 3, 0))
    back = th.deinterleave_packs(inter).numpy().view(np.uint32)
    f0 = (back & np.uint32(0xFFFF0000)).view(np.float32)
    f1 = (back << np.uint32(16)).view(np.float32)
    bf16 = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.stack([f0, f1], -1), bf16)
    for packs in (1, 3):
        with pytest.raises(ValueError):
            th.pack_bf16_table(torch.zeros((packs * L, 8, 128, 2)), L)


def test_encoding_module_reads_a_table_updated_in_place():
    """``ParityHashEncoding``'s f32 encode after the table changes in
    place between two calls (as Adam updates it) gives the new table's
    features, against JAX on each table: no copy of the table is kept."""
    from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding

    kw = dict(num_levels=6, min_res=16, max_res=512, log2_hashmap_size=16,
              features_per_level=8, hash_fn="morton")
    mod = ParityHashEncoding(device="cpu", **kw)
    scalings, t0, pos = _inputs(6, mod.num_steps, 4, 16, 512, n=200, seed=4)
    t1 = np.random.default_rng(5).uniform(-0.5, 0.5, t0.shape).astype(np.float32)
    mod.table.data.copy_(torch.from_numpy(t0))
    outs = []
    for t in (t0, t1):
        with torch.no_grad():
            mod.table.copy_(torch.from_numpy(t))
            outs.append(mod(torch.from_numpy(pos)))
        ref = hp.parity_hash_encode(jnp.asarray(t), jnp.asarray(pos), scalings,
                                    mod.num_steps, 0, "morton")
        np.testing.assert_allclose(outs[-1].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert (outs[0] - outs[1]).abs().max() > 0.1


@pytest.mark.parametrize("hash_fn", HASH_FNS)
def test_index_math_is_exact(hash_fn):
    """lo / hi agree exactly on dense and hashed levels, and the weights."""
    steps = 64
    scalings, _, pos = _inputs(6, steps, 1, 16, 512, n=4096, seed=3)
    s = np.arange(8, dtype=np.int32)[:, None]
    ts = torch.arange(8)[:, None]
    for scale, dense, half in hp._level_plan(scalings, steps):
        lo, hi, w = hp._corner_index_math(
            jnp.asarray(pos[:, 0][None]), jnp.asarray(pos[:, 1][None]),
            jnp.asarray(pos[:, 2][None]), scale, dense, half, steps,
            s & 1, (s >> 1) & 1, (s >> 2) & 1, hash_fn)
        tp = torch.from_numpy(pos)
        tlo, thi, tw = th._corner_index_math(
            tp[:, 0][None], tp[:, 1][None], tp[:, 2][None], scale, dense, half,
            steps, ts & 1, (ts >> 1) & 1, (ts >> 2) & 1, hash_fn)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(w))


@pytest.mark.parametrize("steps", (4, 3, 64))
@pytest.mark.parametrize("qbits", (8, 4))
def test_quantize_packing_is_bit_exact(qbits, steps):
    _, table, _ = _inputs(3, steps, 2, 4, 64)
    packed, scales = hp.quantize_parity_table(jnp.asarray(table), qbits=qbits)
    tpacked, tscales = th.quantize_parity_table(torch.from_numpy(table), qbits=qbits)
    assert tpacked.dtype == torch.float32
    np.testing.assert_array_equal(tpacked.numpy().view(np.uint32),
                                  np.asarray(packed).view(np.uint32))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(scales))


@pytest.mark.parametrize("qbits", (8, 4))
def test_optimal_quant_scales_match(qbits):
    _, table, _ = _inputs(4, 4, 1, 4, 64)
    ref = hp.optimal_quant_scales(jnp.asarray(table), qbits=qbits)
    out = th.optimal_quant_scales(torch.from_numpy(table), qbits=qbits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_bake_quantized_tables_is_bit_exact():
    _, table, _ = _inputs(2, 4, 1, 4, 64)
    tree = {"enc": {"table": table}, "mlp": {"kernel": np.ones((2, 2), np.float32)}}
    ref = hp.bake_quantized_tables({"enc": {"table": jnp.asarray(table)},
                                    "mlp": {"kernel": jnp.ones((2, 2))}},
                                   optimize=0)
    out = th.bake_quantized_tables(
        {"enc": {"table": torch.from_numpy(tree["enc"]["table"])},
         "mlp": {"kernel": torch.ones(2, 2)}}, optimize=0)
    assert set(out["enc"]) == set(ref["enc"]) and set(out["mlp"]) == {"kernel"}
    for k in ("qtable8", "qtable4", "qscales8", "qscales4"):
        np.testing.assert_array_equal(out["enc"][k].numpy().view(np.uint32),
                                      np.asarray(ref["enc"][k]).view(np.uint32))


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    scalings, table, pos = _inputs(4, 4, 1, 4, 64)
    before = (th.parity_hash_encode.launches, th.parity_hash_encode_q8.launches)
    t, p = torch.from_numpy(table), torch.from_numpy(pos)
    out = th.parity_hash_encode(t, p, scalings, 4, "morton")
    torch.testing.assert_close(out, th.parity_hash_encode_ref(t, p, scalings, 4,
                                                              "morton"),
                               rtol=0, atol=0)
    packed, scales = th.quantize_parity_table(t)
    th.parity_hash_encode_q8(th.interleave_packs(packed, 4), scales, p, scalings, 4)
    assert (th.parity_hash_encode.launches,
            th.parity_hash_encode_q8.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    scalings, table, pos = _inputs(4, 4, 1, 4, 64)
    t, p = torch.from_numpy(table), torch.from_numpy(pos)
    with pytest.raises(ValueError):
        th.parity_hash_encode(t.double(), p, scalings, 4)
    with pytest.raises(ValueError):
        th.parity_hash_encode(t, p[:, :2].contiguous(), scalings, 4)
    with pytest.raises(ValueError):
        th.parity_hash_encode(t, p.t().contiguous().t(), scalings, 4)
    with pytest.raises(ValueError):
        th.parity_hash_encode(t, p, scalings, 8)            # wrong steps
    with pytest.raises(ValueError):
        th.parity_hash_encode(t, p, scalings, 4, "cuckoo")
    packed, scales = th.quantize_parity_table(t, qbits=8)
    inter = th.interleave_packs(packed, 4)
    with pytest.raises(ValueError):                         # q8 packing, q4 read
        th.parity_hash_encode_q8(inter, scales, p, scalings, 4, qbits=4)
    with pytest.raises(ValueError):
        th.parity_hash_encode_q8(inter, scales[:2], p, scalings, 4)
    with pytest.raises(ValueError):                         # the packed layout
        th.parity_hash_encode_q8(packed, scales, p, scalings, 4)
    with pytest.raises(ValueError):                         # 3 packs
        th.parity_hash_encode_q8(torch.zeros((4, 16, 128, 3)), torch.zeros(12), p,
                                 scalings, 4)

