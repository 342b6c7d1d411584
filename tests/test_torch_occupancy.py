"""The port's serve occupancy (``samnerf_tpu_torch/ops/occupancy.py``)
against the JAX package's on the CPU, on the same numpy inputs.

Everything here is exact: max pools, integer cell indices from the same
f32 products, and table lookups.  So every comparison is bit for bit.
``tile_live_points`` runs on the JAX package's own point stream, and
the port's ``stream_tile_live`` on [R, S] points must give JAX's
liveness in both stream orders (block-major at R = 2048, sample-major at
R = 96 and 1024); ``tile_live_points`` also on a stream whose tile does
not divide it (per-point liveness).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from samnerf_tpu.fields.nerfacto_field import _flatten_sample_major
from samnerf_tpu.ops import occupancy as jocc
from samnerf_tpu.ops.hash_pallas import _pick_tile
from samnerf_tpu_torch.ops import occupancy as tocc


def _cells(res, frac, seed=0):
    return (np.random.default_rng(seed).random((res, res, res)) < frac).astype(np.float32)


def _ball(res, radius=0.25):
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x * x + y * y + z * z <= radius * radius).astype(np.float32)


def _pack_both(cells):
    return jocc.pack_serve_occupancy(cells), tocc.pack_serve_occupancy(cells, device="cpu")


@pytest.mark.parametrize("res", (8, 12, 96))
def test_pack_serve_occupancy_mips_match_jax(res):
    j, t = _pack_both(_cells(res, 0.02, seed=res))
    assert len(t.mips) == len(j.mips) >= 1
    assert torch.equal(t.table, torch.cat(t.mips))
    for a, b in zip(t.mips, j.mips):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", (8192 * 3, 1000, 128 * 5))
def test_pick_tile_matches_jax(n):
    assert tocc.pick_tile(n) == _pick_tile(n, 8192)


def _points(n, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def test_occupancy_live_matches_jax():
    res = 16
    j, t = _pack_both(_cells(res, 0.05))
    p = _points(4096, 1)
    want = np.asarray(jocc.occupancy_live(j, jnp.asarray(p), res))
    got = tocc.occupancy_live(t, torch.from_numpy(p), res).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def _clustered(n_tiles, tile, res, seed):
    """A stream of ``n_tiles`` tiles, each packed in a box: centred inside
    the ball (live) or near a corner (dead) in turn, of a size that fits
    the finest mip, a coarser one, or (the whole cube) none."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_tiles):
        size = [0.5 / res, 1.5 / res, 5.0 / res, 1.0][(k // 2) % 4]
        c = np.full(3, 0.5) if k % 2 == 0 else np.full(3, size / 2 + 0.01)
        c = np.clip(c + rng.uniform(-0.02, 0.02, 3), size / 2, 1 - size / 2)
        out.append(rng.uniform(c - size / 2, c + size / 2, (tile, 3)))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("case", ("divides", "no_divide", "explicit_tile"))
def test_tile_live_points_matches_jax(case):
    res = 16
    j, t = _pack_both(_ball(res, 0.3))
    if case == "divides":
        p, tile = _clustered(16, 8192, res, 2), 0
    elif case == "no_divide":
        p, tile = _points(128 * 7 + 5, 3), 0
    else:
        p, tile = _clustered(64, 256, res, 4), 256
    want = np.asarray(jocc.tile_live_points(j, jnp.asarray(p), res, tile))
    got = tocc.tile_live_points(t, torch.from_numpy(p), res, tile).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("rays,samples", ((2048, 32), (96, 32), (1024, 16)))
def test_stream_tile_live_matches_jax_stream(rays, samples):
    """[R, S] points whose JAX stream is made of compact tiles: the port's
    liveness, mapped back to [R, S], equals JAX's on its own stream mapped
    back by its own unflatten.  R = 2048 streams block-major, R = 96 and
    1024 sample-major.  Grouping the points in any other order would mix
    live and dead boxes and keep more points live."""
    res = 16
    j, t = _pack_both(_ball(res, 0.3))
    n = rays * samples
    tile = _pick_tile(n, 8192)
    _, unflatten = _flatten_sample_major(jnp.zeros((rays, samples, 3)))
    stream = _clustered(n // tile, tile, res, rays)
    p = np.array(unflatten(jnp.asarray(stream)))
    flat, _ = _flatten_sample_major(jnp.asarray(p))
    np.testing.assert_array_equal(np.asarray(flat), stream)
    want = np.asarray(unflatten(jocc.tile_live_points(j, flat, res)))
    got = tocc.stream_tile_live(t, torch.from_numpy(p), res).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    port_flat, port_unflatten = tocc.stream_order(torch.from_numpy(p))
    np.testing.assert_array_equal(port_flat.numpy(), stream)
    np.testing.assert_array_equal(port_unflatten(port_flat).numpy(), p)


@pytest.mark.parametrize("res,sub", ((4, 2), (5, 3)))
def test_grid_cell_positions_and_cells_from_density_match_jax(res, sub):
    np.testing.assert_array_equal(tocc.grid_cell_positions(res, sub),
                                  jocc.grid_cell_positions(res, sub))
    d = np.random.default_rng(res).exponential(0.02, (res, res, res)).astype(np.float32)
    for thr in (0.01, 0.05):
        np.testing.assert_array_equal(
            tocc.cells_from_density(torch.from_numpy(d), thr).numpy(),
            np.asarray(jocc.cells_from_density(jnp.asarray(d), thr)))
