"""The port's hash-encode table gradient (F32-ENC-BWD's plain version,
through ``hash_encode`` and ``ParityHashEncoding``) against ``jax.vjp`` of
the JAX package's ``parity_hash_encode``, on the CPU.

Tolerance rtol 1e-2 / atol 1e-4 with O(1) cotangents: both round the
accumulated gradient to bf16, from float32 sums taken in another order,
so one bf16 step (2^-8 relative) may separate them.  Positions get no
gradient in either package.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.fields.hash_encoding import ParityHashEncoding as JaxEncoding
from samnerf_tpu.ops import hash_pallas as hp
from samnerf_tpu_torch.fields.hash_encoding import ParityHashEncoding
from samnerf_tpu_torch.ops import hash_grid as th

from test_torch_hash_grid import LARGE, SMALL, _inputs

TOL = dict(rtol=1e-2, atol=1e-4)
# both hashes, P = 1 and 4, dense and hashed levels (LARGE has both)
CASES = [("reference", 1, SMALL), ("morton", 4, SMALL),
         ("reference", 4, LARGE), ("morton", 1, LARGE)]


def _cotangent(n, channels, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 1.0, (n, channels)).astype(np.float32)
    g[rng.uniform(size=n) < 0.1] = 0.0          # rows of outside points
    return g


@pytest.mark.parametrize("hash_fn,P,shape", CASES)
def test_table_gradient_matches_jax_vjp(hash_fn, P, shape):
    L, steps, lo_res, hi_res = shape
    scalings, table, pos = _inputs(L, steps, P, lo_res, hi_res)
    g = _cotangent(pos.shape[0], P * 2 * L)
    _, vjp = jax.vjp(lambda t, p: hp.parity_hash_encode(t, p, scalings, steps, 0,
                                                        hash_fn),
                     jnp.asarray(table), jnp.asarray(pos))
    jtab, jpos = vjp(jnp.asarray(g))
    assert not np.asarray(jpos).any()

    t = torch.from_numpy(table).requires_grad_()
    p = torch.from_numpy(pos).requires_grad_()
    th.hash_encode(t, p, scalings, steps, hash_fn).backward(torch.from_numpy(g))
    assert p.grad is None
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jtab), **TOL)
    assert np.abs(np.asarray(jtab)).max() > 0.1
    # the wrapper alone gives the same gradient
    direct = th.parity_hash_encode_bwd(torch.from_numpy(g), torch.from_numpy(pos),
                                       scalings, steps, hash_fn)
    torch.testing.assert_close(direct, t.grad, rtol=0, atol=0)


def test_encoding_module_gradient_matches_jax():
    """``ParityHashEncoding`` pads 200 points to 256 with 0.5; the padded
    rows get zero cotangents and add nothing."""
    kw = dict(num_levels=6, min_res=16, max_res=512, log2_hashmap_size=16,
              features_per_level=4, hash_fn="morton")
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    g = _cotangent(200, 24, seed=3)
    jmod = JaxEncoding(**kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pos))
    params = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)), params)
    _, vjp = jax.vjp(lambda prm: jmod.apply(prm, jnp.asarray(pos)), params)
    (jgrad,) = vjp(jnp.asarray(g))

    mod = ParityHashEncoding(device="cpu", **kw)
    mod.table.data = torch.from_numpy(np.array(params["params"]["table"]))
    out = mod(torch.from_numpy(pos))
    assert out.shape == (200, 24)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(mod.table.grad.numpy(),
                               np.asarray(jgrad["params"]["table"]), **TOL)


@pytest.mark.parametrize("P", (2, 4))
def test_deinterleave_table_grad_is_exact(P):
    """GRAD-DEINTERLEAVE's plain version: scratch cell (l, row, lane) holds
    the 2P sums of pack p, feature f at [p, f]; the master layout gets
    them at row p*L + l, bit for bit."""
    L, rows = 3, 16
    g = np.random.default_rng(6).normal(size=(P * L, rows, 128, 2)).astype(np.float32)
    scratch = np.ascontiguousarray(g.reshape(P, L, rows, 128, 2).transpose(1, 2, 3, 0, 4))
    out = th.deinterleave_table_grad(torch.from_numpy(scratch))
    assert out.shape == g.shape and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), g)
    with pytest.raises(ValueError):                 # the master layout
        th.deinterleave_table_grad(torch.from_numpy(g))
    with pytest.raises(ValueError):                 # one pack: already the master
        th.deinterleave_table_grad(torch.zeros((L, rows, 128, 1, 2)))


def test_cpu_backward_counts_no_launch():
    scalings, table, pos = _inputs(4, 4, 1, 4, 64)
    before = th.parity_hash_encode_bwd.launches
    t = torch.from_numpy(table).requires_grad_()
    th.hash_encode(t, torch.from_numpy(pos), scalings, 4).sum().backward()
    assert th.parity_hash_encode_bwd.launches == before
    with pytest.raises(ValueError):                 # cotangent of another width
        th.parity_hash_encode_bwd(torch.zeros((256, 12)), torch.from_numpy(pos),
                                  scalings, 4)
