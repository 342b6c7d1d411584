"""The port's hand-written CUDA kernels (the hash encodes, FUSED-QMLP and
FLASH-RELPOS) against their plain PyTorch versions, on the card (``cuda``
marker; they skip without one).

This file imports torch and the port only, so it runs on a machine with
a card and no JAX.  ``tests/conftest.py`` imports JAX, so run it there
without the conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Max abs error, not allclose, so a flipped corner index shows: features
are O(0.5) and a wrong corner moves one by O(0.1).  The table gradient is
held at rtol 1e-2 / atol 1e-4: the kernel sums in f32 with atomics, the
plain version rounds the sum to bf16, as JAX's CPU vjp does.  The f32
layout passes (BF16-PACK, GRAD-DEINTERLEAVE) are permutations and are
held to equality.
FUSED-QMLP is held at rtol 1e-4 / atol 1e-4 (the JAX kernel test's
tolerance): its MLP sums in another order than the plain matmuls, and
the wide heads' in 3xTF32 on the tensor cores (about 1e-6 relative).
FLASH-RELPOS is held at max abs error 1e-4: outputs are softmax averages
of O(1) values, f32 sums over the keys in another order differ by about
1e-6, and a wrong key tile or bias index moves an output by 1e-2 or more.
"""
import numpy as np
import pytest
import torch

from samnerf_tpu_torch.ops import attention as ta
from samnerf_tpu_torch.ops import hash_grid as th
from samnerf_tpu_torch.ops.encodings import hash_grid_scalings


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hash_fn", ("reference", "morton", "morton6"))
def test_cuda_kernels_match_plain_versions(hash_fn):
    """Both kernels at a shape with dense and hashed levels, P = 4, and a
    point count that is not a multiple of the block size."""
    dev = _cuda()
    steps = 64
    scalings = tuple(hash_grid_scalings(6, 16, 512).tolist())
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (4 * 6, steps * 8, 128, 2))
                             .astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (100_003, 3))
                           .astype(np.float32)).to(dev)
    before = th.parity_hash_encode.launches
    out = th.parity_hash_encode(table, pos, scalings, steps, hash_fn)
    assert th.parity_hash_encode.launches == before + 1
    ref = th.parity_hash_encode_ref(table, pos, scalings, steps, hash_fn)
    assert (out - ref).abs().max().item() < 1e-5
    for qbits in (8, 4):
        packed, scales = th.quantize_parity_table(table, qbits=qbits)
        before = th.parity_hash_encode_q8.launches
        out = th.parity_hash_encode_q8(th.interleave_packs(packed, 6), scales, pos,
                                       scalings, steps, hash_fn, qbits=qbits)
        assert th.parity_hash_encode_q8.launches == before + 1
        ref = th._parity_hash_encode_q8_ref(packed, scales, pos, scalings, steps,
                                            hash_fn, qbits)
        assert (out - ref).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", (5, 70_001))
@pytest.mark.parametrize("packs", (1, 2, 4))
def test_q_encode_kernel_matches_plain_version(packs, n):
    """Q-ENC on the serve layout at 1, 2 and 4 packs, for fewer points than
    one tile and for a ragged last tile, with a block of points at the
    sentinel 0.5; the per-pack sums run in the plain version's order."""
    dev = _cuda()
    steps = 64
    scalings = tuple(hash_grid_scalings(6, 16, 512).tolist())
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (packs * 6, steps * 8, 128, 2))
                             .astype(np.float32)).to(dev)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[: n // 10] = 0.5
    pos = torch.from_numpy(pos).to(dev)
    for qbits in (8, 4):
        packed, scales = th.quantize_parity_table(table, qbits=qbits)
        out = th.parity_hash_encode_q8(th.interleave_packs(packed, 6), scales, pos,
                                       scalings, steps, "morton", qbits=qbits)
        ref = th._parity_hash_encode_q8_ref(packed, scales, pos, scalings, steps,
                                            "morton", qbits)
        torch.cuda.synchronize()
        assert out.shape == (n, 2 * packs * 6)
        assert (out - ref).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hash_fn", ("reference", "morton"))
def test_cuda_backward_kernel_matches_plain_version(hash_fn):
    """F32-ENC-BWD through autograd against the plain backward, with O(1)
    cotangents, a tenth of the rows zeroed as outside points are, and a
    block of points at one position (a hot spot of atomics)."""
    dev = _cuda()
    steps = 64
    scalings = tuple(hash_grid_scalings(6, 16, 512).tolist())
    rng = np.random.default_rng(1)
    pos = rng.uniform(0.0, 1.0, (50_001, 3)).astype(np.float32)
    pos[:5000] = 0.5
    g = rng.normal(0.0, 1.0, (50_001, 4 * 2 * 6)).astype(np.float32)
    g[rng.uniform(size=50_001) < 0.1] = 0.0
    pos, g = torch.from_numpy(pos).to(dev), torch.from_numpy(g).to(dev)
    table = torch.zeros((4 * 6, steps * 8, 128, 2), device=dev, requires_grad=True)
    before = th.parity_hash_encode_bwd.launches
    th.hash_encode(table, pos, scalings, steps, hash_fn).backward(g)
    assert th.parity_hash_encode_bwd.launches == before + 1
    ref = th.parity_hash_encode_bwd_ref(g, pos, scalings, steps, hash_fn)
    torch.testing.assert_close(table.grad, ref, rtol=1e-2, atol=1e-4)


def _f32_case(dev, packs, n, where, seed):
    """A 6-level table with dense and hashed levels, positions (uniform,
    all at one point, or all at the origin as outside points are) and
    O(1) cotangents with a tenth of the rows zero and, in another tenth,
    the first pack's channels zero."""
    steps = 64
    scalings = tuple(hash_grid_scalings(6, 16, 512).tolist())
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (packs * 6, steps * 8, 128, 2)).astype(np.float32)
    if where == "uniform":
        pos = rng.uniform(0.0, 1.0, (n, 3))
    else:
        pos = np.broadcast_to(rng.uniform(0.0, 1.0, 3) if where == "one_point"
                              else np.zeros(3), (n, 3))
    g = rng.normal(0.0, 1.0, (n, packs * 2 * 6)).astype(np.float32)
    u = rng.uniform(size=n)
    g[u < 0.1] = 0.0
    g[(u >= 0.1) & (u < 0.2), :12] = 0.0
    return (scalings, steps, *(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                               for a in (table, pos, g)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (5, 70_001))
@pytest.mark.parametrize("packs", (1, 2, 4))
def test_f32_kernels_match_plain_versions(packs, n):
    """F32-ENC and F32-ENC-BWD at 1, 2 and 4 packs, for fewer points than
    one tile and a ragged last tile; at 2 and 4 packs each call launches
    its layout pass once."""
    dev = _cuda()
    scalings, steps, table, pos, g = _f32_case(dev, packs, n, "uniform", 4)
    before = (th.parity_hash_encode.launches, th.pack_bf16_table.launches,
              th.parity_hash_encode_bwd.launches, th.deinterleave_table_grad.launches)
    out = th.parity_hash_encode(table, pos, scalings, steps, "morton")
    grad = th.parity_hash_encode_bwd(g, pos, scalings, steps, "morton")
    torch.cuda.synchronize()
    after = (th.parity_hash_encode.launches, th.pack_bf16_table.launches,
             th.parity_hash_encode_bwd.launches, th.deinterleave_table_grad.launches)
    passes = int(packs > 1)
    assert [a - b for a, b in zip(after, before)] == [1, passes, 1, passes]
    ref = th.parity_hash_encode_ref(table, pos, scalings, steps, "morton")
    assert out.shape == (n, 2 * packs * 6)
    assert (out - ref).abs().max().item() < 1e-5
    ref = th.parity_hash_encode_bwd_ref(g, pos, scalings, steps, "morton")
    torch.testing.assert_close(grad, ref, rtol=1e-2, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ("one_point", "origin"))
@pytest.mark.parametrize("packs", (1, 2, 4))
def test_f32_backward_merges_lanes_that_share_cells(packs, where):
    """Every point at one interior position, or every point at the origin
    (where outside points go) with nonzero cotangents: each warp's 32
    lanes hit the same 8 cells, so the warp merge carries every sum and
    the atomics contend; rows with zero cotangents mixed in."""
    dev = _cuda()
    scalings, steps, _, pos, g = _f32_case(dev, packs, 20_001, where, 5)
    grad = th.parity_hash_encode_bwd(g, pos, scalings, steps, "morton")
    ref = th.parity_hash_encode_bwd_ref(g, pos, scalings, steps, "morton")
    torch.cuda.synchronize()
    assert ref.abs().max().item() > 10.0
    torch.testing.assert_close(grad, ref, rtol=1e-2, atol=1e-4)
    zero = th.parity_hash_encode_bwd(torch.zeros_like(g), pos, scalings, steps, "morton")
    assert not zero.any()


@pytest.mark.cuda
@pytest.mark.parametrize("packs", (2, 4))
def test_f32_layout_passes_match_plain_versions(packs):
    """BF16-PACK and GRAD-DEINTERLEAVE against their plain versions, bit
    for bit."""
    dev = _cuda()
    _, _, table, _, _ = _f32_case(dev, packs, 5, "uniform", 6)
    packed = th.pack_bf16_table(table, 6)
    plain = th.interleave_packs(th._bf16_words(table), 6)
    assert torch.equal(packed.view(torch.int32), plain.view(torch.int32))
    scratch = torch.randn((6, table.shape[1], 128, packs, 2), device=dev)
    assert torch.equal(th.deinterleave_table_grad(scratch),
                       scratch.permute(3, 0, 1, 2, 4).reshape(table.shape))


@pytest.mark.cuda
def test_encoding_module_on_the_card_reads_a_table_updated_in_place():
    """``ParityHashEncoding`` (4 packs, so F32-ENC reads the bf16 copy)
    after the table changes in place between two calls gives the new
    table's features: the copy is made on every call."""
    from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding

    dev = _cuda()
    mod = ParityHashEncoding(num_levels=6, min_res=16, max_res=512, log2_hashmap_size=16,
                             features_per_level=8, hash_fn="morton", device=dev)
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (1000, 3)).astype(np.float32)).to(dev)
    for _ in range(2):
        with torch.no_grad():
            mod.table.copy_(torch.from_numpy(
                rng.uniform(-0.5, 0.5, tuple(mod.table.shape)).astype(np.float32)))
            out = mod(pos)
        ref = th.parity_hash_encode_ref(mod.table.detach(), pos, mod.scalings,
                                        mod.num_steps, "morton")
        assert (out - ref).abs().max().item() < 1e-5


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    scalings = tuple(hash_grid_scalings(4, 4, 64).tolist())
    table = torch.zeros((4, 32, 128, 2), device=dev)
    pos = torch.full((256, 3), 0.5, device=dev)
    with pytest.raises(ValueError):                    # table on another device
        th.parity_hash_encode(table.cpu(), pos, scalings, 4)
    with pytest.raises(ValueError):                    # strided positions
        th.parity_hash_encode(table, pos.t().contiguous().t(), scalings, 4)
    with pytest.raises(ValueError):                    # cotangent of another width
        th.parity_hash_encode_bwd(torch.zeros((256, 6), device=dev), pos,
                                  scalings, 4)
    with pytest.raises(ValueError):                    # 3 packs
        th.parity_hash_encode(torch.zeros((12, 32, 128, 2), device=dev), pos, scalings, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", (8, 4))
@pytest.mark.parametrize("heads", ("single", "stacked", "sam", "clipseg", "proposal",
                                   "below_tile"))
def test_fused_qmlp_kernel_matches_plain_version(heads, qbits):
    """One pyramid with dense and hashed levels (C 24 -> H 16 -> O 1, N not
    a multiple of any tile), two stacked pyramids of other scalings (24 ->
    32 -> 9), the SAM head's widths (two 12-level pyramids of 4 packs,
    192 -> 256 -> 256, 50 KB of shared memory and more per block), the
    ClipSeg head's (192 -> 256 -> 192 at its 8,192 points, the 32-point
    tile), the proposal head's (one 5-level pyramid of 1 pack, 10 -> 16
    -> 1) and the nerfacto head's widths at fewer points than one tile."""
    dev = _cuda()
    rng = np.random.default_rng(2)
    steps = 64 if heads in ("single", "proposal", "below_tile") else 8
    if heads == "sam":
        spec, (h, o), n = [(12, 4, 16, 128), (12, 4, 128, 512)], (256, 256), 20_011
    elif heads == "clipseg":
        spec, (h, o), n = [(12, 4, 16, 128), (12, 4, 128, 512)], (256, 192), 8192
    elif heads == "stacked":
        spec, (h, o), n = [(3, 2, 4, 64), (3, 2, 8, 128)], (32, 9), 30_001
    elif heads == "proposal":
        spec, (h, o), n = [(5, 1, 16, 128)], (16, 1), 50_001
    elif heads == "below_tile":
        spec, (h, o), n = [(16, 1, 16, 2048)], (64, 16), 37
    else:
        spec, (h, o), n = [(6, 2, 16, 512)], (16, 1), 100_003
    packed, scales, scalings = [], [], []
    for levels, packs, lo, hi in spec:
        table = torch.from_numpy(rng.uniform(-0.5, 0.5, (packs * levels, steps * 8, 128, 2))
                                 .astype(np.float32)).to(dev)
        pk, sc = th.quantize_parity_table(table, qbits=qbits)
        packed.append(pk)
        scales.append(sc)
        scalings.append(tuple(hash_grid_scalings(levels, lo, hi).tolist()))
    c = sum(2 * p.shape[0] for p in packed)
    serve = [th.interleave_packs(pk, len(s)) for pk, s in zip(packed, scalings)]
    w1, b1, w2, b2 = (torch.from_numpy((rng.normal(size=s) * f).astype(np.float32)).to(dev)
                      for s, f in (((c, h), c ** -0.5), ((h,), 0.1), ((h, o), h ** -0.5),
                                   ((o,), 0.1)))
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)).to(dev)
    args = (scales, pos, scalings, steps, w1, b1, w2, b2, "morton", qbits)
    before = th.parity_hash_encode_qmlp.launches
    out = th.parity_hash_encode_qmlp(serve, *args)
    assert th.parity_hash_encode_qmlp.launches == before + 1
    ref = th._parity_hash_encode_qmlp_ref(packed, *args)
    torch.cuda.synchronize()
    assert out.shape == (n, o)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_qmlp_wrapper_rejects_tensors_on_other_devices():
    dev = _cuda()
    scalings = tuple(hash_grid_scalings(4, 4, 64).tolist())
    packed, scales = th.quantize_parity_table(torch.zeros((4, 32, 128, 2), device=dev))
    packed = th.interleave_packs(packed, 4)
    pos = torch.full((256, 3), 0.5, device=dev)
    w1, b1, w2, b2 = (torch.zeros(s, device=dev) for s in ((8, 4), (4,), (4, 2), (2,)))
    with pytest.raises(ValueError):
        th.parity_hash_encode_qmlp([packed], [scales], pos, [scalings], 4,
                                   w1.cpu(), b1, w2, b2)
    with pytest.raises(ValueError):
        th.parity_hash_encode_qmlp([packed], [scales.cpu()], pos, [scalings], 4,
                                   w1, b1, w2, b2)


def _attention_inputs(dev, b, kh, kw, d, seed=0):
    """q, k, v ~ N(0, 1) and rel-pos terms at the scale a seeded layer
    gives (tables N(0, 0.02) contracted with q: std about 0.02 sqrt(D))."""
    rng = np.random.default_rng(seed)
    n = kh * kw
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev)
               for _ in range(3))
    rel = 0.02 * np.sqrt(d)
    rel_h = torch.from_numpy((rng.normal(size=(b, n, kh)) * rel).astype(np.float32))
    rel_w = torch.from_numpy((rng.normal(size=(b, n, kw)) * rel).astype(np.float32))
    return q, k, v, rel_h.to(dev), rel_w.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 12, 20, 20), (2, 5, 7, 33), (16, 64, 64, 80)])
def test_flash_relpos_kernel_matches_plain_version(shape):
    """(B*heads, Kh, Kw, D): ragged tiles (N = 240, 35), D not a power of
    two, and the ViT-H global layer (N = 4096, D = 80)."""
    dev = _cuda()
    b, kh, kw, d = shape
    args = _attention_inputs(dev, b, kh, kw, d)
    before = ta.flash_attention_relpos.launches
    out = ta.flash_attention_relpos(*args, d ** -0.5)
    assert ta.flash_attention_relpos.launches == before + 1
    ref = ta.reference_attention_relpos(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "device", "shape", "strided", "head_dim"])
def test_flash_relpos_wrapper_rejects_what_the_kernel_does_not_take(bad):
    dev = _cuda()
    q, k, v, rel_h, rel_w = _attention_inputs(dev, 2, 4, 8, 16)
    if bad == "dtype":
        q = q.half()
    elif bad == "device":
        v = v.cpu()
    elif bad == "shape":
        rel_h = rel_h[:, :, :3].contiguous()
    elif bad == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        q, k, v = (torch.zeros((2, 32, 136), device=dev) for _ in range(3))
    with pytest.raises(ValueError):
        ta.flash_attention_relpos(q, k, v, rel_h, rel_w, 0.25)
