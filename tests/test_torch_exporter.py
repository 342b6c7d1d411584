"""Geometry export of the port against the JAX package, on the CPU.

- The writers and back-projections are the JAX package's numpy code:
  PLY bytes, OBJ text and the back-projected arrays are held equal.
- ``marching_tetrahedra`` gives JAX's vertices and faces, in JAX's order,
  on the same grid (a sphere's SDF, a masked TSDF, JAX's Poisson chi).
- ``tsdf_integrate`` over three views at resolution 24: the world-to-camera
  matmul sums in another order, so a voxel whose projection lies within
  float noise of a pixel edge may read the neighbouring pixel.  TSDF,
  weight and colour agree to atol 1e-5 at all but at most 0.1% of the
  voxels.
- Poisson at resolution 20: the splat of the oriented normals agrees to
  atol 1e-5 (adds of one corner meet in another order); chi after 200 CG
  steps, shifted by its iso value, to a relative (max-norm) tolerance of
  1e-3; the mesh from JAX's chi is JAX's mesh.
- ``scripts/exporter.py``'s ``main`` in all three modes on a tiny run
  directory: files that parse, with the counts it printed.
"""
import dataclasses
import re
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.exporter import exporter as jex
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.engine.trainer import TrainerConfig
from samnerf_tpu_torch.exporter import exporter as tex
from samnerf_tpu_torch.scripts import exporter as export_script
from samnerf_tpu_torch.utils import synthetic

from test_torch_train_slice import GROUPS, TINY
from test_torch_trainer_eval import _dm_config


def _cloud(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.uniform(-0.2, 1.2, size=(n, 3)),
            rng.normal(size=(n, 3)))


@pytest.mark.parametrize("with_colors,with_normals", [(True, False), (False, True),
                                                      (True, True), (False, False)])
def test_ply_bytes_equal_jax(tmp_path, with_colors, with_normals):
    pts, cols, nrm = _cloud()
    kw = dict(colors=cols if with_colors else None, normals=nrm if with_normals else None)
    jex.export_ply(tmp_path / "j.ply", pts, **kw)
    tex.export_ply(tmp_path / "t.ply", pts, **kw)
    raw = (tmp_path / "t.ply").read_bytes()
    assert raw == (tmp_path / "j.ply").read_bytes()
    body = raw.split(b"end_header\n", 1)[1]
    np.testing.assert_array_equal(struct.unpack("<3f", body[:12]), pts[0].astype(np.float32))


@pytest.mark.parametrize("with_colors", [False, True])
def test_obj_text_equal_jax(tmp_path, with_colors):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(7, 3))
    faces = rng.integers(0, 7, size=(5, 3))
    colors = rng.uniform(size=(7, 3)) if with_colors else None
    jex.export_obj(tmp_path / "j.obj", verts, faces, colors)
    tex.export_obj(tmp_path / "t.obj", verts, faces, colors)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


def _view(seed, h=24, w=32):
    """A rendered-looking view: depth, rgb, accumulation, intrinsics, c2w."""
    rng = np.random.default_rng(seed)
    depth = 1.0 + rng.uniform(0, 0.5, size=(h, w, 1)) + np.linspace(0, 0.3, w)[None, :, None]
    rgb = rng.uniform(size=(h, w, 3))
    acc = rng.uniform(size=(h, w, 1))
    intrin = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    theta = 0.4 * seed
    c2w = np.array([[np.cos(theta), 0, np.sin(theta), 1.2 * np.sin(theta)],
                    [0, 1, 0, 0.1],
                    [-np.sin(theta), 0, np.cos(theta), 1.2 * np.cos(theta)]])
    return depth, rgb, acc, intrin, c2w


@pytest.mark.parametrize("stride", [1, 2])
def test_backprojections_equal_jax(stride):
    depth, rgb, acc, intrin, c2w = _view(1)
    for a, b in zip(tex.backproject_depth(depth, rgb, acc, intrin, c2w, 0.3, stride),
                    jex.backproject_depth(depth, rgb, acc, intrin, c2w, 0.3, stride)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tex.depth_to_oriented_points(depth, acc, intrin, c2w),
                    jex.depth_to_oriented_points(depth, acc, intrin, c2w)):
        np.testing.assert_array_equal(a, b)


def _sphere_sdf(res=20):
    g = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.55


@pytest.mark.parametrize("masked", [False, True])
def test_marching_tetrahedra_identical(masked):
    sdf = _sphere_sdf()
    aabb = np.array([[-1.0, -1, -1], [1, 1, 1]])
    mask = (np.abs(sdf) < 0.3) if masked else None
    tv, tf = tex.marching_tetrahedra(sdf, aabb, mask=mask)
    jv, jf = jex.marching_tetrahedra(sdf, aabb, mask=mask)
    assert len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


TSDF_RES = 24
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def test_tsdf_integrate_matches_jax():
    jstate = jex.tsdf_init(TSDF_RES)
    tstate = tex.tsdf_init(TSDF_RES, device="cpu")
    for seed in (1, 2, 3):
        depth, rgb, _, intrin, c2w = _view(seed)
        jstate = jex.tsdf_integrate(jstate, jnp.asarray(depth[..., 0]), jnp.asarray(rgb),
                                    jnp.asarray(intrin), jnp.asarray(c2w),
                                    jnp.asarray(AABB), trunc=0.2)
        f32 = dict(dtype=torch.float32)
        tstate = tex.tsdf_integrate(tstate, torch.as_tensor(depth[..., 0], **f32),
                                    torch.as_tensor(rgb, **f32),
                                    torch.as_tensor(intrin, **f32),
                                    torch.as_tensor(c2w, **f32), torch.as_tensor(AABB),
                                    trunc=0.2)
    for name, j, t in zip(("tsdf", "weight", "color"), jstate, tstate):
        j, t = np.asarray(j), t.numpy()
        assert t.shape == j.shape
        bad = np.abs(t - j) > 1e-5
        if bad.ndim == 4:
            bad = bad.any(-1)
        assert bad.mean() <= 1e-3, (name, int(bad.sum()))
    assert float(tstate[1].sum()) > 100            # views do reach the volume
    mask = tstate[1].numpy() > 0
    tv, tf = tex.marching_tetrahedra(tstate[0].numpy(), AABB, mask=mask)
    assert len(tf) > 0


def _oriented_sphere(n=600, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return 0.5 * d, d


POISSON_RES = 20


def test_poisson_splat_matches_jax():
    pts, nrm = _oriented_sphere()
    pts01 = ((pts - AABB[0]) / (AABB[1] - AABB[0])).astype(np.float32)
    nrm = nrm.astype(np.float32)
    j = jex._splat_trilinear(jnp.zeros((POISSON_RES,) * 3 + (3,)), jnp.asarray(pts01),
                             jnp.asarray(nrm))
    t = tex._splat_trilinear(torch.zeros((POISSON_RES,) * 3 + (3,)),
                             torch.as_tensor(pts01), torch.as_tensor(nrm))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    s_j = jex._sample_trilinear(j[..., 0], jnp.asarray(pts01))
    s_t = tex._sample_trilinear(t[..., 0], torch.as_tensor(pts01))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5, rtol=0)


def test_poisson_chi_and_mesh_match_jax(monkeypatch):
    pts, nrm = _oriented_sphere()
    grids = []
    mt = jex.marching_tetrahedra

    def capture(values, aabb, *a, **kw):
        grids.append((np.array(values), np.array(aabb)))
        return mt(values, aabb, *a, **kw)

    monkeypatch.setattr(jex, "marching_tetrahedra", capture)
    jv, jf = jex.poisson_reconstruct(pts, nrm, AABB, resolution=POISSON_RES)
    (jchi, jaabb), = grids
    tchi = tex.poisson_indicator(pts, nrm, AABB, resolution=POISSON_RES,
                                 device="cpu").numpy()
    scale = np.abs(jchi).max()
    assert scale > 0
    np.testing.assert_allclose(tchi / scale, jchi / scale, atol=1e-3, rtol=0)
    tv, tf = tex.marching_tetrahedra(jchi, jaabb)
    assert len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    # and the port's own mesh, from its own chi, lies on the same sphere
    ov, _ = tex.poisson_reconstruct(pts, nrm, AABB, resolution=POISSON_RES, device="cpu")
    assert abs(np.median(np.linalg.norm(ov, axis=-1))
               - np.median(np.linalg.norm(jv, axis=-1))) < 1e-2


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny run directory: config and the checkpoint of 2 CPU steps."""
    scene = synthetic.write_scene(tmp_path_factory.mktemp("scene"), num_train=4,
                                  num_test=2, h=32, w=32, with_features=True,
                                  feature_long_side=8)
    out = tmp_path_factory.mktemp("run")
    config = method_configs()["samnerf_distill"]
    config.model = dataclasses.replace(TINY, num_nerf_samples_per_ray=8)
    config.datamanager = _dm_config(scene)
    config.optimizers = GROUPS
    config.trainer = TrainerConfig(max_num_iterations=2, steps_per_save=100000,
                                   steps_per_eval_batch=0, output_dir=out)
    config.vis = "json"
    train_cli.save_config(config)
    train_cli.train_loop(config, device="cpu")
    return out


def _obj_counts(path):
    lines = path.read_text().splitlines()
    verts = np.array([[float(x) for x in ln.split()[1:4]] for ln in lines
                      if ln.startswith("v ")]).reshape(-1, 3)
    faces = np.array([[int(x) for x in ln.split()[1:4]] for ln in lines
                      if ln.startswith("f ")]).reshape(-1, 3)
    assert np.isfinite(verts).all()
    # each triangle emits its own crossings: 3 vertices, or 4 for a quad's 2
    assert 2 * len(faces) <= len(verts) <= 3 * len(faces)
    if len(faces):
        assert faces.min() >= 1 and faces.max() <= len(verts)
    return len(verts), len(faces)


@pytest.mark.parametrize("mode", ["pointcloud", "tsdf", "poisson"])
def test_exporter_script_modes(run_dir, tmp_path, capsys, mode):
    out = tmp_path / ("cloud.ply" if mode == "pointcloud" else "mesh.obj")
    argv = [mode, str(run_dir), "--output", str(out), "--num-views", "2", "--width", "16",
            "--height", "16", "--resolution", "12"]
    assert export_script.main(argv, device="cpu") == 0
    printed = capsys.readouterr().out
    if mode == "pointcloud":
        raw = out.read_bytes()
        header, body = raw.split(b"end_header\n", 1)
        n = int(re.search(rb"element vertex (\d+)", header).group(1))
        assert len(body) == n * 15                     # 3 floats and 3 bytes each
        assert f"wrote {n} points" in printed
        pts = np.frombuffer(body, dtype=np.dtype([("p", "<f4", 3), ("c", "u1", 3)]))["p"]
        assert np.isfinite(pts).all()
    elif mode == "tsdf":
        v, f = _obj_counts(out)
        assert f"wrote mesh ({v} verts, {f} faces)" in printed
    else:
        _obj_counts(out)
        assert re.search(r"wrote poisson mesh from \d+ oriented points", printed)


def test_exporter_script_needs_a_card_by_default(run_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert export_script.main(["tsdf", str(run_dir), "--output",
                               str(tmp_path / "m.obj")]) == 1
