"""Lens distortion and the fisheye and equirectangular camera models of the
port against the JAX package, on the CPU.

- ``undistort_coords`` (JAX's fixed three-step solve) at rtol / atol 1e-6;
- ``generate_rays`` with distortion, fisheye, equirectangular and mixed
  camera types: origins bit for bit, directions at atol 1e-6 (torch's and
  XLA's sin / cos / sqrt may differ in the last bit), pixel areas at rtol
  1e-4 (differences of neighbouring unit directions, ~1/f apart, carry
  that last bit relative to 1/f);
- the nerfstudio parser's shared and per-frame distortion keys: the same
  cameras and distortion parameters as JAX's, and no parameters when all
  are zero;
- a distorted scene's train step rays equal JAX's, and the scene trains;
- fisheye and equirectangular camera paths render through
  ``scripts/render.py`` to the frames ``ImageRenderer`` renders.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.core import cameras as jc
from samnerf_tpu.data import dataparser as jdp
from samnerf_tpu_torch.core import camera_paths as tcp
from samnerf_tpu_torch.core import cameras as tc
from samnerf_tpu_torch.data import dataparser as tdp
from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from samnerf_tpu_torch.engine.eval_render import ImageRenderer
from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
from samnerf_tpu_torch.scripts import render as render_script
from samnerf_tpu_torch.utils import synthetic

from test_torch_camera_paths import _path_json, run_dir, run_trainer  # noqa: F401
from test_torch_train_slice import GROUPS, TINY
from test_torch_trainer_eval import scene  # noqa: F401 (fixture of run_dir)

N, R = 3, 200
DIST = np.array([[0.08, -0.03, 0.01, 0.002, 0.001, -0.002],
                 [-0.1, 0.02, 0.0, 0.0, -0.003, 0.002],
                 [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(ctype=None, dist=None, seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.stack([synthetic.look_at_c2w(rng.uniform(0.5, 1.5, 3),
                                          rng.uniform(-0.1, 0.1, 3))[:3]
                    for _ in range(N)]).astype(np.float32)
    fx = rng.uniform(20, 40, (N, 1)).astype(np.float32)
    fy = (fx * 1.05).astype(np.float32)
    cx = np.full((N, 1), 24.5, np.float32)
    cy = np.full((N, 1), 15.5, np.float32)
    ct = None if ctype is None else np.asarray(ctype, np.int32).reshape(N, 1)
    j = jc.Cameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(fx), fy=jnp.asarray(fy),
                   cx=jnp.asarray(cx), cy=jnp.asarray(cy), width=48, height=32,
                   distortion_params=None if dist is None else jnp.asarray(dist),
                   camera_type=None if ct is None else jnp.asarray(ct))
    t = tc.Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(fx),
                   fy=torch.from_numpy(fy), cx=torch.from_numpy(cx), cy=torch.from_numpy(cy),
                   width=48, height=32,
                   distortion_params=None if dist is None else torch.from_numpy(dist),
                   camera_type=None if ct is None else torch.from_numpy(ct))
    idx = rng.integers(0, N, R).astype(np.int32)
    coords = np.stack([rng.integers(0, 32, R), rng.integers(0, 48, R)], -1).astype(np.int32)
    return j, t, idx, coords


def _assert_rays(t_rays, j_rays):
    np.testing.assert_array_equal(t_rays.origins.numpy(), np.asarray(j_rays.origins))
    np.testing.assert_allclose(t_rays.directions.numpy(), np.asarray(j_rays.directions),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_rays.pixel_area.numpy(), np.asarray(j_rays.pixel_area),
                               rtol=1e-4)
    np.testing.assert_array_equal(t_rays.camera_indices.numpy(),
                                  np.asarray(j_rays.camera_indices))


def test_undistort_coords_matches_jax():
    rng = np.random.default_rng(1)
    coords = rng.uniform(-0.9, 0.9, (3, 64, 2)).astype(np.float32)
    dist = (rng.normal(size=(1, 64, 6)) * [0.1, 0.03, 0.01, 0.003, 0.002, 0.002]
            ).astype(np.float32)
    for iters in (1, 3, 5):
        ours = tc.undistort_coords(torch.from_numpy(coords), torch.from_numpy(dist), iters)
        ref = jc.undistort_coords(jnp.asarray(coords), jnp.asarray(dist), iters)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # without distortion the coords come back unchanged
    zero = tc.undistort_coords(torch.from_numpy(coords), torch.zeros(1, 64, 6))
    np.testing.assert_array_equal(zero.numpy(), coords)


@pytest.mark.parametrize("ctype,dist", [
    (None, DIST),
    ([jc.FISHEYE] * N, None),
    ([jc.EQUIRECTANGULAR] * N, None),
    ([jc.PERSPECTIVE, jc.FISHEYE, jc.EQUIRECTANGULAR], DIST),
])
def test_generate_rays_matches_jax(ctype, dist):
    j, t, idx, coords = _both(ctype, dist)
    ours = tc.generate_rays(t, torch.from_numpy(idx), torch.from_numpy(coords))
    ref = jc.generate_rays(j, jnp.asarray(idx), jnp.asarray(coords))
    _assert_rays(ours, ref)
    if dist is not None:                     # distortion moves the rays
        plain = tc.generate_rays(tc.Cameras(**{**t.__dict__, "distortion_params": None}),
                                 torch.from_numpy(idx), torch.from_numpy(coords))
        bent = idx != 2
        assert (ours.directions - plain.directions)[bent].abs().max() > 1e-3


def test_rescaled_cameras_keep_their_distortion():
    j, t, idx, coords = _both(None, DIST)
    ours = t.rescale_output_resolution(0.5)
    ref = j.rescale_output_resolution(0.5)
    assert (ours.width, ours.height) == (ref.width, ref.height) == (24, 16)
    _assert_rays(tc.generate_rays(ours, torch.from_numpy(idx), torch.from_numpy(coords // 2)),
                 jc.generate_rays(ref, jnp.asarray(idx), jnp.asarray(coords // 2)))


def _write_transforms(root, shared=None, per_frame=None, n=5):
    rng = np.random.default_rng(2)
    frames = []
    for i in range(n):
        c2w = synthetic.look_at_c2w(np.array([np.cos(i), np.sin(i), 0.5]) * 2, np.zeros(3))
        frame = {"file_path": f"images/f{i}.png", "transform_matrix": c2w.tolist(),
                 "fl_x": float(rng.uniform(30, 40)), "fl_y": float(rng.uniform(30, 40))}
        if per_frame is not None:
            frame.update({k: float(v) for k, v in zip(per_frame, rng.normal(size=6) * 0.05)})
        frames.append(frame)
    meta = {"cx": 16.0, "cy": 12.0, "h": 24, "w": 32, "frames": frames, **(shared or {})}
    root.mkdir(parents=True, exist_ok=True)
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("case", ("shared", "per_frame", "shared_k4_only", "zeros",
                                  "shared_downscaled"))
def test_dataparser_distortion_matches_jax(tmp_path, case):
    """Also with ``downscale_factor`` 2: the intrinsics and size rescaled,
    the (normalised) distortion kept."""
    shared, per_frame = {
        "shared": ({"k1": 0.05, "k2": -0.01, "p1": 0.001, "p2": 0.002}, None),
        "shared_downscaled": ({"k1": 0.05, "k2": -0.01, "p1": 0.001, "p2": 0.002}, None),
        "per_frame": (None, ("k1", "k2", "k3", "k4", "p1", "p2")),
        # k4 alone does not make the top level shared (JAX's rule): the
        # frames' (absent) keys decide, so no distortion
        "shared_k4_only": ({"k4": 0.02}, None),
        "zeros": ({"k1": 0.0, "k2": 0.0, "k3": 0.0, "p1": 0.0, "p2": 0.0}, None),
    }[case]
    root = _write_transforms(tmp_path / "scene", shared, per_frame)
    for split in ("train", "test"):
        kw = dict(data=root, train_split_fraction=0.6,
                  downscale_factor=2 if case.endswith("downscaled") else None)
        ours = tdp.parse_nerfstudio_data(tdp.DataparserConfig(**kw), split)
        ref = jdp.parse_nerfstudio_data(jdp.DataparserConfig(**kw), split)
        assert (ours.cameras.width, ours.cameras.height, ours.downscale_factor) == \
            (ref.cameras.width, ref.cameras.height, ref.downscale_factor)
        assert ours.cameras.num_cameras == ref.cameras.num_cameras == (3 if split == "train"
                                                                       else 2)
        for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(getattr(ours.cameras, k).numpy(),
                                          np.asarray(getattr(ref.cameras, k)), err_msg=k)
        if ref.cameras.distortion_params is None:
            assert ours.cameras.distortion_params is None
        else:
            np.testing.assert_array_equal(ours.cameras.distortion_params.numpy(),
                                          np.asarray(ref.cameras.distortion_params))
    assert (ours.cameras.distortion_params is not None) == (case in ("shared", "per_frame",
                                                                     "shared_downscaled"))


@pytest.fixture(scope="module")
def distorted_scene(tmp_path_factory):
    root = synthetic.write_scene(tmp_path_factory.mktemp("distorted"), num_train=4,
                                 num_test=1, h=32, w=32, with_features=True,
                                 feature_long_side=8)
    for name in ("transforms_train.json", "transforms_test.json"):
        meta = json.loads((root / name).read_text())
        meta.update(k1=0.04, k2=-0.01, p1=0.002, p2=-0.001)
        (root / name).write_text(json.dumps(meta))
    return root


def test_distorted_scene_trains(distorted_scene, tmp_path):
    from samnerf_tpu.core.cameras import generate_rays as jax_rays
    from samnerf_tpu.data.datamanager import (DataManager as JaxDataManager,
                                              DataManagerConfig as JaxDMConfig)

    dp = tdp.DataparserConfig(data=distorted_scene, train_val_json_split=True)
    dm = DataManager(DataManagerConfig(dataparser=dp, train_num_rays_per_batch=128,
                                       patch_size=2, distill_sam=True,
                                       use_clipseg_feature=True))
    jdm = JaxDataManager(JaxDMConfig(dataparser=jdp.DataparserConfig(
        data=distorted_scene, train_val_json_split=True)), load_images=False)
    assert dm.cameras.distortion_params is not None
    np.testing.assert_array_equal(dm.cameras.distortion_params.numpy(),
                                  np.asarray(jdm.cameras.distortion_params))
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 4, 64).astype(np.int32)
    coords = rng.integers(0, 32, (64, 2)).astype(np.int32)
    _assert_rays(tc.generate_rays(dm.cameras, torch.from_numpy(idx), torch.from_numpy(coords)),
                 jax_rays(jdm.cameras, jnp.asarray(idx), jnp.asarray(coords)))
    trainer = Trainer(TINY, TrainerConfig(max_num_iterations=3, steps_per_save=100000,
                                          steps_per_eval_batch=0, steps_per_eval_image=0,
                                          output_dir=tmp_path), GROUPS, dm, device="cpu")
    losses = []
    trainer.train(step_callback=lambda s, m: losses.append(float(m["total_loss"])))
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("kind", ("fisheye", "equirectangular"))
def test_render_script_renders_other_camera_models(run_dir, run_trainer, tmp_path,  # noqa: F811
                                                   kind):
    path = _path_json(n=2, kind=kind)
    (tmp_path / "path.json").write_text(json.dumps(path))
    args = ["--traj", "filename", "--camera-path-filename", str(tmp_path / "path.json"),
            "--output", str(tmp_path / "frames")]
    assert render_script.main([str(run_dir)] + args, device="cpu") == 0
    cams = tcp.get_path_from_json(path)
    assert int(cams.camera_type[0, 0]) == {"fisheye": tc.FISHEYE,
                                           "equirectangular": tc.EQUIRECTANGULAR}[kind]
    renderer = ImageRenderer(run_trainer.model)
    frames = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(frames) == 2
    perspective = tcp.get_path_from_json(_path_json(n=2))
    for i, f in enumerate(frames):
        rgb = renderer.render_image(cams, i)["rgb"]
        want = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(f)), want)
        flat = renderer.render_image(perspective, i)["rgb"]
        assert np.abs(rgb - flat).max() > 1e-3          # another camera model
