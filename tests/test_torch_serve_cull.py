"""Serve-time culling in the port (occupancy grid, early ray termination)
against the JAX package on the CPU, on the same numpy-drawn weights.

- ``get_density`` of both fields with a partial grid, at R = 2048 rays
  (the JAX stream is block-major) and R = 96 (sample-major): the grid is
  tested per tile of the JAX stream, so the same points are culled.
  Culled densities are exactly 0 in both; the rest agree within rtol
  1e-5 (f32 sums in another order through the hash encode and the MLP).
- An all-occupied grid gives the port's un-culled output bit for bit (f32,
  int8 and fused int8 tables), and empty cells give zero density.
- ``SAMModel``'s eval forward with a grid and ``serve_transmittance_eps``
  against JAX: depth and accumulation rtol 1e-4 and rgb atol 1e-4, as
  ``test_torch_render_view.py``.  The eps is one from which every
  transmittance estimate keeps 1e-5 away, so no sample flips on rounding.
- ``bake_density_grid`` at res 8 (rtol 1e-5) and the packed grid of a
  threshold that every cell density keeps 1e-4 (relative) away from.
- ``render_view`` with a partial grid: 64x64 views in 2048-ray chunks
  (block-major), a click locked and a moved view, with the tolerances of
  ``test_torch_render_view.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from samnerf_tpu.engine import eval_render as jer
from samnerf_tpu.engine import render_pipeline as jrp
from samnerf_tpu.models.sam_model import SAMModel as JaxModel
from samnerf_tpu.ops import occupancy as jocc
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu.perception.sam.predictor import SamPredictor as JaxPredictor
from samnerf_tpu_torch.convert import params_from_jax
from samnerf_tpu_torch.core.rays import RayBundle
from samnerf_tpu_torch.engine import eval_render as ter
from samnerf_tpu_torch.engine import render_pipeline as trp
from samnerf_tpu_torch.models.sam_model import SAMModel
from samnerf_tpu_torch.ops import occupancy as tocc
from samnerf_tpu_torch.ops.samplers import proposal_sampling
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam

from test_model import TINY
from test_torch_convert import decoder_state, port_config
from test_torch_render_view import INTRIN, _check_view
from test_torch_serve_slice import _model_params
from samnerf_tpu_torch.utils.synthetic import look_at_c2w

OCC_RES = 16
CFG = dataclasses.replace(TINY, hash_fn="morton", occ_res=OCC_RES)
DENSITY_TOL = dict(rtol=1e-5, atol=1e-7)
# the presets' sample counts, for the model and view tests: a tile of the
# stream is then 8 depths of a 1024-ray block (with TINY's 8 samples a
# tile spans whole rays, and a grid never culls one)
PRESET_COUNTS = dict(num_nerf_samples_per_ray=32, num_proposal_samples_per_ray=(64,))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _half_cells(res=OCC_RES):
    """Occupied where the unit x < 0.5: world x < 0 inside the unit ball."""
    cells = np.zeros((res, res, res), np.float32)
    cells[: res // 2] = 1.0
    return cells


def _ball_cells(res=OCC_RES, radius=0.2):
    """Occupied inside a ball of ``radius`` about the unit cube's centre."""
    c = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x * x + y * y + z * z <= radius * radius).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, port model) over the same weights."""
    params = _model_params(CFG)
    model = SAMModel(port_config(CFG), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return JaxModel(CFG), params, model


def _positions(rays, samples, seed):
    """[R, S, 3] world points in compact groups of JAX's stream tiles:
    rays in blocks of 1024 (R = 2048) or samples in runs of depth (R = 96)
    sit near world x = -0.6 (live) or x = +0.7 (dead), so a tile's box is
    small and lies on one side."""
    rng = np.random.default_rng(seed)
    side = np.zeros((rays, samples), np.float32)
    if rays > 1024:
        side[1024:] = 1.0
    else:
        side[:, samples // 2:] = 1.0
    centre = np.stack([np.where(side > 0, 0.7, -0.6), np.zeros_like(side),
                       np.zeros_like(side)], -1)
    return (centre + rng.uniform(-0.05, 0.05, (rays, samples, 3))).astype(np.float32)


@pytest.mark.parametrize("field", ("nerfacto", "proposal"))
@pytest.mark.parametrize("rays", (2048, 96))
def test_get_density_with_a_partial_grid_matches_jax(models, field, rays):
    jmodel, params, model = models
    cells = _half_cells()
    jgrid = jocc.pack_serve_occupancy(cells)
    grid = tocc.pack_serve_occupancy(cells, device="cpu")
    pos = _positions(rays, 8, rays)
    if field == "nerfacto":
        jd, jgeo = jax.jit(lambda p, x, o: jmodel.apply(
            p, x, o, method=lambda m, x, o: m.fields.get_density(x, o)))(
                params, jnp.asarray(pos), jgrid)
        d, geo = model.fields.get_density(torch.from_numpy(pos), grid)
        np.testing.assert_allclose(geo.detach().numpy(), np.asarray(jgeo), **DENSITY_TOL)
    else:
        jd = jax.jit(lambda p, x, o: jmodel.apply(
            p, x, o, method=lambda m, x, o: m.proposal_networks[0](x, o)))(
                params, jnp.asarray(pos), jgrid)
        d = model.proposal_networks[0](torch.from_numpy(pos), grid)
    d, jd = d.detach().numpy(), np.asarray(jd)
    np.testing.assert_array_equal(d == 0.0, jd == 0.0)
    np.testing.assert_allclose(d, jd, **DENSITY_TOL)
    assert 0.2 < (jd == 0.0).mean() < 0.8


@pytest.mark.parametrize("tables", ("f32", "int8", "int8_fused"))
def test_all_occupied_grid_is_bit_for_bit_and_empty_cells_are_zero(models, tables):
    _, params, _ = models
    cfg = port_config(dataclasses.replace(CFG, hash_q8_serve=tables != "f32",
                                          serve_fuse_mlp=tables == "int8_fused"))
    model = SAMModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    full = tocc.pack_serve_occupancy(np.ones((OCC_RES,) * 3, np.float32), device="cpu")
    empty = tocc.pack_serve_occupancy(np.zeros((OCC_RES,) * 3, np.float32), device="cpu")
    pos = torch.from_numpy(_positions(2048, 8, 7))
    dirs = torch.nn.functional.normalize(torch.randn(2048, 3, generator=torch.Generator()
                                                     .manual_seed(0)), dim=-1)
    with torch.no_grad():
        base = model.fields(pos, dirs)
        culled = model.fields(pos, dirs, full)
        for k in ("density", "rgb"):
            assert torch.equal(culled[k], base[k]), k
        prop = model.proposal_networks[0]
        assert torch.equal(prop(pos, full), prop(pos))
        assert not model.fields(pos, dirs, empty)["density"].any()
        assert not prop(pos, empty).any()
        assert base["density"].min() > 0


# cameras outside the grid's ball (world radius 0.8), looking at the origin.
# A feature sample within f32 rounding of a hash cell's boundary can fall
# in another cell in each package: at the eye (1.1, 1.5, 1.2) one ClipSeg
# and one SAM ray did (top-k weights and mids equal to 4e-7, features
# 0.08 apart).  The second eye is one where no sample does.
EYES = (np.array([1.5, 1.1, 1.2]), np.array([1.2, 1.4, 1.25]))


def _bundle(rays, seed=0):
    """Rays from ``EYES[0]`` towards the origin, spread by 0.15."""
    rng = np.random.default_rng(seed)
    d = rng.normal(-EYES[0] / np.linalg.norm(EYES[0]), 0.15, (rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(EYES[0][None], (rays, 1))
    return o.astype(np.float32), d.astype(np.float32)


ETA_CANDIDATES = (0.25, 0.3, 0.2, 0.35, 0.15)
ETA_MARGIN = 1e-5   # f32 sums of 64 weights <= 1 in two orders differ by < 4e-6


def _transmittance(model, bundle, grid):
    """The port's [R, S] transmittance estimates at the nerf samples."""
    cfg = model.config
    with torch.no_grad():
        rb = bundle.with_near_far(cfg.near_plane, cfg.far_plane)
        samples, wl, sl = proposal_sampling(
            rb, [lambda x, p=p: p(x, grid) for p in model.proposal_networks],
            cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray)
    pw, pend = wl[-1][..., 0], sl[-1].ends[..., 0]
    tmid = (samples.starts + samples.ends)[..., 0] * 0.5
    return 1.0 - torch.where(pend[:, None, :] <= tmid[:, :, None], pw[:, None, :],
                             0.0).sum(-1)


@pytest.mark.parametrize("early", (False, True))
def test_sam_model_eval_with_grid_and_early_termination_matches_jax(models, early):
    """With ``early``, eps is the first of ``ETA_CANDIDATES`` that every
    estimate keeps ``ETA_MARGIN`` away from, so no sample sits where the
    two packages' rounding could decide it."""
    from samnerf_tpu.core.rays import RayBundle as JaxBundle

    _, params, shared = models
    model = trp.serve_model(shared)     # the same weights under another config
    model.config = dataclasses.replace(model.config, **PRESET_COUNTS)
    cells = _ball_cells()
    grid = tocc.pack_serve_occupancy(cells, device="cpu")
    o, d = _bundle(2048)
    pa = np.full((2048, 1), 1e-6, np.float32)
    tb = RayBundle(origins=torch.from_numpy(o), directions=torch.from_numpy(d),
                   pixel_area=torch.from_numpy(pa))
    eps = 0.0
    if early:
        t_est = _transmittance(model, tb, grid)
        eps = next(e for e in ETA_CANDIDATES if (t_est - e).abs().min() > ETA_MARGIN)
        assert 0.1 < (t_est <= eps).float().mean() < 0.9
    model.config = dataclasses.replace(model.config, serve_transmittance_eps=eps)
    jmodel = JaxModel(dataclasses.replace(CFG, serve_transmittance_eps=eps, **PRESET_COUNTS))
    jb = JaxBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                   pixel_area=jnp.asarray(pa), camera_indices=jnp.zeros((2048, 1), jnp.int32))
    ref = jax.jit(lambda p, b, g: jmodel.apply(p, b, train=False, occupancy=g))(
        params, jb, jocc.pack_serve_occupancy(cells))
    out = model(tb, occupancy=grid)
    for k, tol in (("depth", dict(rtol=1e-4, atol=1e-6)),
                   ("accumulation", dict(rtol=1e-4, atol=1e-6)),
                   ("prop_depth_0", dict(rtol=1e-4, atol=1e-6)),
                   ("rgb", dict(rtol=0, atol=1e-4))):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), err_msg=k, **tol)
    model.config = dataclasses.replace(model.config, serve_transmittance_eps=0.0)
    base = model(tb)
    key = "rgb" if early else "depth"
    assert (base[key] - out[key]).abs().max() > (1e-3 if early else 1e-2)


def test_bake_density_grid_and_occupancy_match_jax(models):
    jmodel, params, model = models
    ref = jer.bake_density_grid(jmodel, params, res=8, sub=2, chunk=1024)
    got = ter.bake_density_grid(model, res=8, sub=2, chunk=1024)
    assert got.shape == ref.shape == (8, 8, 8)
    np.testing.assert_allclose(got, ref, **DENSITY_TOL)
    # the threshold: the middle of the widest gap between sorted cell
    # densities near the median, so both packages' cells fall on one side
    v = np.sort(ref.ravel())
    i = 192 + int(np.argmax(np.diff(v[192:321])))
    thr = float(v[i] + v[i + 1]) / 2.0
    assert np.abs(ref / thr - 1.0).min() > 1e-4
    jgrid, jfrac = jer.occupancy_from_cells(ref, thr)
    grid, frac = ter.occupancy_from_cells(got, thr, device="cpu")
    assert frac == jfrac and 0 < frac < 1
    for a, b in zip(grid.mips, jgrid.mips):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def culled_renderers(models):
    """JAX and port renderers (static preset, 2048-ray chunks, the
    presets' sample counts) with a partial grid installed and SAM
    predictors over the same decoder."""
    _, params, shared = models
    model = trp.serve_model(shared)
    model.config = dataclasses.replace(model.config, **PRESET_COUNTS)
    jmodel = JaxModel(dataclasses.replace(CFG, **PRESET_COUNTS))
    dec_sd = decoder_state(3, for_masks=True)
    jsam, _ = build_sam("vit_b")
    jpred = JaxPredictor(jsam, {"params": convert_torch_state_dict(dec_sd, depth=12)})
    jsnr = jrp.SamNerfRenderer(jmodel, sam_predictor=jpred, chunk=2048, serve_preset="static")
    sam = Sam(device="cpu")
    sam.load_state_dict(dec_sd)
    snr = trp.SamNerfRenderer(model, sam_predictor=SamPredictor(sam), chunk=2048,
                              serve_preset="static")
    cells = _ball_cells()
    jsnr.occ = jocc.pack_serve_occupancy(cells)
    snr.occ = tocc.pack_serve_occupancy(cells, device="cpu")
    return jsnr, params, snr


def test_render_view_with_a_partial_grid_matches_jax(culled_renderers):
    jsnr, params, snr = culled_renderers
    click = np.array([[20.0, 37.0]])
    for c2w in (look_at_c2w(EYES[0], np.zeros(3)), look_at_c2w(EYES[1], np.zeros(3))):
        jcams = jrp.cameras_from_intrin_c2w(INTRIN, c2w, 64, 64)
        ref = jsnr.render_view(params, jcams, 0, INTRIN, c2w, points=click,
                               width=64, height=64)
        cams = trp.cameras_from_intrin_c2w(INTRIN, c2w, 64, 64, device="cpu")
        out = snr.render_view(cams, 0, INTRIN, c2w, points=click, width=64, height=64)
        _check_view((jsnr, params, snr), c2w, ref, out)
        assert len(snr.prompts) == 1
    # the grid changes the frame
    snr_occ, snr.occ = snr.occ, None
    try:
        plain = snr.render_view(cams, 0, INTRIN, c2w, points=click, width=64, height=64)
    finally:
        snr.occ = snr_occ
    assert np.abs(plain["depth"] - out["depth"]).max() > 0.01
