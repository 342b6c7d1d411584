"""The model zoo's ops in the port against the JAX package, on the CPU: the
encodings (flat and temporal hash grid, frequency, Fourier, integrated,
TensoRF / triplane), the normal, depth and MiDaS losses, the AABB and
sphere colliders, the depth / semantic / uncertainty / normal renderers,
linear spacing and ``include_original`` in the samplers, and the training
occupancy grid.

Inputs are drawn with numpy.  Tolerances: rtol 1e-5 / atol 1e-6 for
elementwise math (the packages' sin, cos and exp differ in the last
bits), 1e-6 for the hash encodes (the same corner sums in the same
order), rtol 1e-4 / atol 1e-6 for the factor gradients (scatter-adds in
another order).  The flat hash table's gradient takes atol 1e-5: JAX
reads each slot's sum as the difference of two entries of one f32 prefix
sum over all 8 * L * N contributions, so its absolute error grows with
that running sum (about 1e-7 of it), where the port adds each
contribution into its slot with ``index_add_``.
``occupancy_mask`` and ``update_occupancy`` (given the same densities)
are held bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.core.rays import RayBundle as JRayBundle
from samnerf_tpu.fields.hash_encoding import HashEncoding as JHashEncoding
from samnerf_tpu.ops import (colliders as jcol, encodings as jenc, losses as jloss,
                             occupancy as jocc, rendering as jren, samplers as jsam)
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.fields.hash_encoding import HashEncoding
from samnerf_tpu_torch.ops import (colliders as tcol, encodings as tenc, losses as tloss,
                                   occupancy as tocc, rendering as tren, samplers as tsam)

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_GRAD = dict(rtol=1e-4, atol=1e-6)
TOL_FLAT_GRAD = dict(rtol=1e-4, atol=1e-5)


def f32(*shape, lo=0.0, hi=1.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


# --- hash grids -------------------------------------------------------------

SCALINGS = tuple(jenc.hash_grid_scalings(4, 16, 64).tolist())
LOG2 = 10


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.3)])
def test_flat_hash_encode_and_table_grad(lo, hi):
    """Forward, and the table's gradient under a random cotangent; the
    positions get none (JAX returns zeros, the port None)."""
    table = f32(2, 4 << LOG2, lo=-1, hi=1, seed=1)
    pos = f32(300, 3, lo=lo, hi=hi, seed=2)
    g = f32(300, 8, lo=-1, hi=1, seed=3)
    out, vjp = jax.vjp(lambda tb, p: jenc.hash_encode(tb, p, SCALINGS, LOG2),
                       jnp.asarray(table), jnp.asarray(pos))
    gt, gp = vjp(jnp.asarray(g))
    tt, tp = t(table).requires_grad_(), t(pos).requires_grad_()
    o = tenc.hash_encode(tt, tp, SCALINGS, LOG2)
    close(o, out, dict(rtol=0, atol=1e-6))
    (o * t(g)).sum().backward()
    close(tt.grad, gt, TOL_FLAT_GRAD)
    assert tp.grad is None and not np.asarray(gp).any()


def test_hash_encoding_module():
    jm = JHashEncoding(num_levels=4, max_res=64, log2_hashmap_size=LOG2)
    pos = f32(200, 3, seed=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pos))
    params = jax.tree.map(lambda x: np.asarray(x) * 1e3, params)   # away from 0
    tm = HashEncoding(num_levels=4, max_res=64, log2_hashmap_size=LOG2, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    assert tm.out_dim == jm.out_dim == 8
    close(tm(t(pos)), jm.apply(params, jnp.asarray(pos)), dict(rtol=0, atol=1e-6))


def test_temporal_hash_encode_and_table_grad():
    table = f32(2, 4 << LOG2, lo=-1, hi=1, seed=5)
    pos, times = f32(200, 3, seed=6), f32(200, seed=7)
    g = f32(200, 8, lo=-1, hi=1, seed=8)
    out, vjp = jax.vjp(lambda tb: jenc.temporal_hash_encode(
        tb, jnp.asarray(pos), jnp.asarray(times), SCALINGS, LOG2, 4), jnp.asarray(table))
    (gt,) = vjp(jnp.asarray(g))
    tt = t(table).requires_grad_()
    o = tenc.temporal_hash_encode(tt, t(pos), t(times), SCALINGS, LOG2, 4)
    close(o, out)
    (o * t(g)).sum().backward()
    close(tt.grad, gt, TOL_FLAT_GRAD)


# --- positional encodings ---------------------------------------------------

@pytest.mark.parametrize("freqs", [2, 4, 10])
def test_nerf_frequency_encoding(freqs):
    x = f32(7, 5, 3, lo=-1, hi=1, seed=freqs)
    close(tenc.nerf_frequency_encoding(t(x), freqs),
          jenc.nerf_frequency_encoding(jnp.asarray(x), freqs), dict(rtol=1e-5, atol=2e-6))


def test_rff_encoding():
    x, b = f32(9, 3, lo=-1, hi=1, seed=1), f32(3, 6, lo=-2, hi=2, seed=2)
    close(tenc.rff_encoding(t(x), t(b)), jenc.rff_encoding(jnp.asarray(x), jnp.asarray(b)),
          dict(rtol=1e-5, atol=5e-6))


def _samples(seed=0, r=6, s=5):
    """A JAX and a port RaySamples with sorted edges in [0.1, 2]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(r, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = np.sort(rng.uniform(0.1, 2.0, (r, s + 1)), -1).astype(np.float32)[..., None]
    area = rng.uniform(1e-6, 1e-4, (r, 1)).astype(np.float32)
    jb = JRayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                    pixel_area=jnp.asarray(area))
    tb = RayBundle(origins=t(o), directions=t(d), pixel_area=t(area))
    zeros = np.zeros((r, 1), np.float32)
    js = jsam._make_ray_samples(jb, jnp.asarray(e[..., 0]), jnp.asarray(e[..., 0]),
                                jnp.asarray(zeros), jnp.asarray(zeros))
    ts = tsam._make_ray_samples(tb, t(e[..., 0]), t(e[..., 0]), t(zeros), t(zeros))
    return js, ts


@pytest.mark.parametrize("freqs", [4, 16])
def test_integrated_pos_enc_of_frustums(freqs):
    js, ts = _samples(freqs)
    jm, jc = jenc.conical_frustum_to_gaussian(js)
    tm, tc = tenc.conical_frustum_to_gaussian(ts)
    close(tm, jm)
    close(tc, jc, dict(rtol=1e-4, atol=1e-9))
    close(tenc.integrated_pos_enc(tm, tc, freqs), jenc.integrated_pos_enc(jm, jc, freqs),
          dict(rtol=1e-4, atol=2e-6))


@pytest.mark.parametrize("kind", ["cp", "vm", "triplane_sum", "triplane_product"])
def test_factor_encodings_and_grads(kind):
    """Values and the gradients of the planes / lines under a random
    cotangent, positions partly outside [0, 1] (clipped)."""
    c, res = 4, 9
    planes, lines = f32(3, res, res, c, lo=-1, hi=1, seed=1), f32(3, res, c, lo=-1, hi=1, seed=2)
    pos = f32(50, 3, lo=-0.1, hi=1.1, seed=3)
    jfn = {"cp": lambda p, l: jenc.tensor_cp_encode(l, jnp.asarray(pos)),
           "vm": lambda p, l: jenc.tensor_vm_encode(p, l, jnp.asarray(pos)),
           "triplane_sum": lambda p, l: jenc.triplane_encode(p, jnp.asarray(pos)),
           "triplane_product": lambda p, l: jenc.triplane_encode(p, jnp.asarray(pos),
                                                                 "product")}[kind]
    tfn = {"cp": lambda p, l: tenc.tensor_cp_encode(l, t(pos)),
           "vm": lambda p, l: tenc.tensor_vm_encode(p, l, t(pos)),
           "triplane_sum": lambda p, l: tenc.triplane_encode(p, t(pos)),
           "triplane_product": lambda p, l: tenc.triplane_encode(p, t(pos), "product")}[kind]
    out, vjp = jax.vjp(jfn, jnp.asarray(planes), jnp.asarray(lines))
    g = f32(*out.shape, lo=-1, hi=1, seed=4)
    gp, gl = vjp(jnp.asarray(g))
    tp, tl = t(planes).requires_grad_(), t(lines).requires_grad_()
    o = tfn(tp, tl)
    close(o, out)
    (o * t(g)).sum().backward()
    for port, ref in ((tp, gp), (tl, gl)):
        if port.grad is None:
            assert not np.asarray(ref).any()
        else:
            close(port.grad, ref, TOL_GRAD)


# --- losses -----------------------------------------------------------------

def _loss_inputs(seed=0, r=8, s=6):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 0.3, (r, s, 1)).astype(np.float32)
    steps = np.sort(rng.uniform(0.1, 2.0, (r, s)), -1).astype(np.float32)[..., None]
    lengths = rng.uniform(0.01, 0.3, (r, s, 1)).astype(np.float32)
    depth = rng.uniform(0.2, 1.8, (r, 1)).astype(np.float32)
    depth[2] = 0.0                                    # a ray without depth
    pred = rng.uniform(0.2, 1.8, (r, 1)).astype(np.float32)
    n = rng.normal(size=(r, s, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pn = rng.normal(size=(r, s, 3)).astype(np.float32)
    v = rng.normal(size=(r, 3)).astype(np.float32)
    return w, steps, lengths, depth, pred, n, pn, v


@pytest.mark.parametrize("sigma", [0.01, 0.1])
def test_depth_losses(sigma):
    w, steps, lengths, depth, pred, *_ = _loss_inputs()
    close(tloss.ds_nerf_depth_loss(t(w), t(depth), t(steps), t(lengths), sigma),
          jloss.ds_nerf_depth_loss(*map(jnp.asarray, (w, depth, steps, lengths)), sigma))
    close(tloss.urban_radiance_field_depth_loss(t(w), t(depth), t(pred), t(steps), sigma),
          jloss.urban_radiance_field_depth_loss(*map(jnp.asarray, (w, depth, pred, steps)),
                                                sigma))


def test_normal_losses():
    w, *_, n, pn, v = _loss_inputs(1)
    close(tloss.orientation_loss(t(w), t(n), t(v)),
          jloss.orientation_loss(jnp.asarray(w), jnp.asarray(n), jnp.asarray(v)))
    close(tloss.pred_normal_loss(t(w), t(n), t(pn)),
          jloss.pred_normal_loss(jnp.asarray(w), jnp.asarray(n), jnp.asarray(pn)))


@pytest.mark.parametrize("scales", [1, 4])
def test_midas_losses(scales):
    rng = np.random.default_rng(scales)
    pred = rng.uniform(0, 1, (3, 16, 12)).astype(np.float32)
    target = (2.0 * pred + 0.3 + rng.normal(0, 0.05, pred.shape)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.2).astype(np.float32)
    mask[2] = 0.0                                    # a singular image: scale 0
    j = [jnp.asarray(a) for a in (pred, target, mask)]
    for port, ref in zip(tloss.midas_scale_shift(t(pred), t(target), t(mask)),
                         jloss.midas_scale_shift(*j)):
        close(port, ref, dict(rtol=1e-4, atol=1e-5))
    close(tloss.midas_depth_loss(t(pred), t(target), t(mask), scales),
          jloss.midas_depth_loss(*j, scales), dict(rtol=1e-4, atol=1e-6))


# --- colliders, renderers, samplers -----------------------------------------

def _bundles(seed=0, r=16):
    """Rays from a ring of origins at radius 3 toward jittered points near
    the centre (some miss a unit box)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, r)
    o = np.stack([3 * np.cos(ang), 3 * np.sin(ang), rng.uniform(-0.5, 0.5, r)], -1)
    d = rng.normal(0, 0.6, (r, 3)) - o
    d[0] = [0.0, 0.0, 1.0]                           # axis-parallel: a zero component
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    area = np.full((r, 1), 1e-5, np.float32)
    return (JRayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                       pixel_area=jnp.asarray(area)),
            RayBundle(origins=t(o), directions=t(d), pixel_area=t(area)))


@pytest.mark.parametrize("near_plane", [0.0, 2.5])
def test_colliders(near_plane):
    jb, tb = _bundles()
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    ja, ta = jcol.aabb_collider(jb, jnp.asarray(aabb), near_plane), \
        tcol.aabb_collider(tb, t(aabb), near_plane)
    close(ta.nears, ja.nears)
    close(ta.fars, ja.fars)
    center = np.array([0.1, -0.1, 0.0], np.float32)
    js, ts = jcol.sphere_collider(jb, jnp.asarray(center), 1.2, near_plane), \
        tcol.sphere_collider(tb, t(center), 1.2, near_plane)
    close(ts.nears, js.nears)
    close(ts.fars, js.fars)
    assert (np.asarray(ja.fars - ja.nears) < 1e-5).any()      # some rays miss


@pytest.mark.parametrize("single_jitter", [True, False])
@pytest.mark.parametrize("include_original", [True, False])
def test_linear_samplers(single_jitter, include_original):
    """``initial_samples`` with linear spacing and jitter of both shapes
    (JAX's draws), then ``pdf_samples`` of random weights."""
    jb, tb = _bundles(1)
    aabb = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
    jb = jcol.aabb_collider(jb, jnp.asarray(aabb), 0.05)
    tb = tcol.aabb_collider(tb, t(aabb), 0.05)
    key = jax.random.PRNGKey(3)
    lin = lambda x: x  # noqa: E731
    js = jsam.initial_samples(key, jb, 6, stratified=True, single_jitter=single_jitter,
                              spacing_fn=lin, spacing_inv=lin)
    shape = tsam.jitter_shape(16, 6, single_jitter)
    ts = tsam.initial_samples(tb, 6, t(jax.random.uniform(key, shape)),
                              spacing_fn=tsam.spacing_linear, spacing_inv=tsam.spacing_linear)
    close(ts.starts, js.starts)
    close(ts.ends, js.ends)
    w = f32(16, 6, 1, seed=5)
    jp = jsam.pdf_samples(key, jb, js, jnp.asarray(w), 5, stratified=True,
                          single_jitter=single_jitter, include_original=include_original,
                          spacing_inv=lin)
    tp = tsam.pdf_samples(tb, ts, t(w), 5, t(jax.random.uniform(
        key, tsam.jitter_shape(16, 5, single_jitter))), include_original=include_original,
        spacing_inv=tsam.spacing_linear)
    assert tp.starts.shape == jp.starts.shape == (16, 5 + (7 if include_original else 0), 1)
    close(tp.starts, jp.starts)
    close(tp.ends, jp.ends)


def test_renderers():
    rng = np.random.default_rng(7)
    r, s = 10, 6
    w = rng.uniform(0, 0.3, (r, s, 1)).astype(np.float32)
    w[1] = 0.0                                       # a ray with no weight
    e = np.sort(rng.uniform(0.1, 2.0, (r, s + 1)), -1).astype(np.float32)
    jb, tb = _bundles(0, r)
    jsamp = jsam._make_ray_samples(jb, jnp.asarray(e), jnp.asarray(e),
                                   jnp.zeros((r, 1)), jnp.zeros((r, 1)))
    tsamp = tsam._make_ray_samples(tb, t(e), t(e), torch.zeros(r, 1), torch.zeros(r, 1))
    close(tren.render_depth_expected(t(w), tsamp), jren.render_depth_expected(jnp.asarray(w), jsamp))
    logits = rng.normal(size=(r, s, 5)).astype(np.float32)
    close(tren.render_semantics(t(logits), t(w)),
          jren.render_semantics(jnp.asarray(logits), jnp.asarray(w)))
    betas = rng.uniform(size=(r, s, 1)).astype(np.float32)
    close(tren.render_uncertainty(t(betas), t(w)),
          jren.render_uncertainty(jnp.asarray(betas), jnp.asarray(w)))
    n = rng.normal(size=(r, s, 3)).astype(np.float32)
    for norm in (True, False):
        close(tren.render_normals(t(n), t(w), norm),
              jren.render_normals(jnp.asarray(n), jnp.asarray(w), norm))
    rgb = rng.uniform(size=(r, s, 3)).astype(np.float32)
    bg = rng.uniform(size=(r, 3)).astype(np.float32)     # per ray, as instant-NGP's
    for train in (True, False):
        close(tren.render_rgb(t(rgb), t(w), "explicit", bg_rgb=t(bg), training=train),
              jren.render_rgb(jnp.asarray(rgb), jnp.asarray(w), "explicit",
                              bg_rgb=jnp.asarray(bg), training=train))


# --- the training occupancy grid --------------------------------------------

@pytest.mark.parametrize("res", [4, 8])
def test_occupancy_mask_bit_for_bit(res):
    grid = (np.random.default_rng(res).uniform(size=(res,) * 3) > 0.5).astype(np.float32)
    aabb = np.array([[-1.0, -1.5, -0.5], [1.0, 0.5, 1.5]], np.float32)
    pos = f32(40, 5, 3, lo=-1.7, hi=1.7, seed=res)
    ref = np.asarray(jocc.occupancy_mask(jnp.asarray(grid), jnp.asarray(pos), jnp.asarray(aabb)))
    out = tocc.occupancy_mask(t(grid), t(pos), t(aabb)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < (ref > 0).mean() < 1


@pytest.mark.parametrize("res,samples", [(4, 100), (8, 2048)])
def test_update_occupancy_bit_for_bit(res, samples):
    """Given JAX's random cells and jitter and the same densities, the new
    EMA densities and the grid match bit for bit (repeated cells take the
    max); the query positions match too."""
    cells = res ** 3
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    gd0 = f32(cells, hi=0.03, seed=res)
    d = f32(samples, 1, hi=0.03, seed=res + 1)
    seen = {}

    def dfn(tag):
        def f(pos):
            seen[tag] = np.array(pos)
            return d if tag == "port" else jnp.asarray(d)
        return f

    key = jax.random.PRNGKey(res)
    jgd, jgrid = jocc.update_occupancy(jnp.asarray(gd0), dfn("jax"), jnp.asarray(aabb), key,
                                       num_samples=samples)
    k1, k2 = jax.random.split(key)
    idx = t(jax.random.randint(k1, (samples,), 0, cells))
    jit = t(jax.random.uniform(k2, (samples, 3)))
    tgd, tgrid = tocc.update_occupancy(t(gd0), lambda p: t(dfn("port")(p)), t(aabb),
                                       idx=idx, jitter=jit)
    np.testing.assert_array_equal(tgd.numpy(), np.asarray(jgd))
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-6)
    assert 0 < np.asarray(jgrid).mean() < 1
    # the port's own draws: a grid of the right shape, deterministic per seed
    a = tocc.update_occupancy(t(gd0), lambda p: torch.full((p.shape[0], 1), 0.5), t(aabb),
                              torch.Generator().manual_seed(0), num_samples=samples)
    b = tocc.update_occupancy(t(gd0), lambda p: torch.full((p.shape[0], 1), 0.5), t(aabb),
                              torch.Generator().manual_seed(0), num_samples=samples)
    assert a[1].shape == (res,) * 3 and torch.equal(a[0], b[0])
