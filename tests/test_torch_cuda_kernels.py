"""The port's hand-written CUDA hash-encode kernels against their plain
PyTorch versions, on the card (``cuda`` marker; they skip without one).

This file imports torch and the port only, so it runs on a machine with
a card and no JAX.  ``tests/conftest.py`` imports JAX, so run it there
without the conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Max abs error, not allclose, so a flipped corner index shows: features
are O(0.5) and a wrong corner moves one by O(0.1).  The table gradient is
held at rtol 1e-2 / atol 1e-4: the kernel sums in f32 with atomics, the
plain version rounds the sum to bf16, as JAX's CPU vjp does.
"""
import numpy as np
import pytest
import torch

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
        out = th.parity_hash_encode_q8(packed, scales, pos, scalings, steps,
                                       hash_fn, qbits=qbits)
        assert th.parity_hash_encode_q8.launches == before + 1
        ref = th._parity_hash_encode_q8_ref(packed, scales, pos, scalings, steps,
                                            hash_fn, qbits)
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
