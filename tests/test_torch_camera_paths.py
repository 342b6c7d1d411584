"""Camera paths and ``scripts/render.py`` of the port against the JAX
package on the CPU.

The paths are numpy on the host in both packages, so the cameras must be
equal: poses and intrinsics bit for bit (f32 from the same f64 values).
``scripts/render.py``'s ``main(..., device="cpu")`` on a tiny run
directory must write, for each trajectory, the PNG frames that
``ImageRenderer`` renders for the same cameras, byte for byte.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from samnerf_tpu.core import camera_paths as jcp
from samnerf_tpu.core.cameras import PERSPECTIVE, Cameras as JaxCameras
from samnerf_tpu_torch import train as train_cli
from samnerf_tpu_torch.configs.methods import method_configs
from samnerf_tpu_torch.core import camera_paths as tcp
from samnerf_tpu_torch.core.cameras import Cameras
from samnerf_tpu_torch.engine.eval_render import ImageRenderer
from samnerf_tpu_torch.engine.trainer import TrainerConfig
from samnerf_tpu_torch.scripts import render as render_script
from samnerf_tpu_torch.utils.eval_utils import eval_setup
from samnerf_tpu_torch.utils.synthetic import look_at_c2w

from test_torch_trainer_eval import _dm_config, scene  # noqa: F401 (fixture)
from test_torch_train_slice import GROUPS, TINY


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both_cameras(n, seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.stack([look_at_c2w(rng.uniform(0.5, 1.5, 3), rng.uniform(-0.1, 0.1, 3))[:3]
                    for _ in range(n)]).astype(np.float32)
    fx = rng.uniform(40, 60, (n, 1)).astype(np.float32)
    fy = fx + np.float32(1.0)
    jc = JaxCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(fx), fy=jnp.asarray(fy),
                    cx=jnp.full((n, 1), 24.0), cy=jnp.full((n, 1), 16.0), width=48, height=32)
    tc = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(fx),
                 fy=torch.from_numpy(fy), cx=torch.full((n, 1), 24.0),
                 cy=torch.full((n, 1), 16.0), width=48, height=32)
    return jc, tc


def _assert_same(t, j):
    assert (t.width, t.height) == (j.width, j.height)
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        a, b = getattr(t, k), np.asarray(getattr(j, k))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


@pytest.mark.parametrize("n,steps", ((4, 5), (2, 1), (1, 3)))
def test_interpolated_camera_path_matches_jax(n, steps):
    jc, tc = _both_cameras(n, seed=n)
    _assert_same(tcp.get_interpolated_camera_path(tc, steps),
                 jcp.get_interpolated_camera_path(jc, steps))


@pytest.mark.parametrize("kw", (dict(radius=0.1), dict(radiuses=(0.1, 0.2, 0.05), rots=1,
                                                       zrate=0.25)))
def test_spiral_path_matches_jax(kw):
    jc, tc = _both_cameras(3, seed=5)
    _assert_same(tcp.get_spiral_path(tc, steps=7, **kw), jcp.get_spiral_path(jc, steps=7, **kw))
    with pytest.raises(ValueError):
        tcp.get_spiral_path(tc, steps=7)


def _path_json(n=3, kind="perspective"):
    rng = np.random.default_rng(1)
    frames = []
    for i in range(n):
        m = np.eye(4)
        m[:3] = look_at_c2w(rng.uniform(0.6, 1.2, 3), np.zeros(3))[:3]
        frames.append({"camera_to_world": m.reshape(-1).tolist(),
                       "fov": None if i == 1 else float(rng.uniform(30, 80)), "aspect": 1.5})
    return {"camera_type": kind, "render_height": 32, "render_width": 48,
            "camera_path": frames, "fps": 24, "seconds": 1}


def test_path_from_json_matches_jax():
    path = _path_json()
    t, j = tcp.get_path_from_json(path), jcp.get_path_from_json(path)
    _assert_same(t, j)
    assert float(t.fx[1, 0]) == 50.0
    np.testing.assert_array_equal(np.asarray(j.camera_type), PERSPECTIVE)


@pytest.mark.parametrize("kind", ("fisheye", "equirectangular"))
def test_path_from_json_refuses_other_camera_models(kind):
    with pytest.raises(ValueError, match="A10"):
        tcp.get_path_from_json(_path_json(kind=kind))


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(3)

    def rotation():
        r = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        return r * np.sign(np.linalg.det(r))

    for _ in range(5):
        r = rotation()
        q = tcp._rot_to_quat(r)
        np.testing.assert_array_equal(q, jcp._rot_to_quat(r))
        np.testing.assert_allclose(tcp._quat_to_rot(q), r, atol=1e-12)
        q2 = tcp._rot_to_quat(rotation())
        for f in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(tcp.quaternion_slerp(q, q2, f),
                                          jcp.quaternion_slerp(q, q2, f))


@pytest.fixture(scope="module")
def run_dir(scene, tmp_path_factory):  # noqa: F811
    """A run directory of the tiny model: its config and a checkpoint."""
    out = tmp_path_factory.mktemp("run")
    config = method_configs()["samnerf_distill"]
    config.model = dataclasses.replace(TINY, num_nerf_samples_per_ray=8)
    config.datamanager = _dm_config(scene)
    config.optimizers = GROUPS
    config.trainer = TrainerConfig(max_num_iterations=1, steps_per_save=100000,
                                   steps_per_eval_batch=0, output_dir=out)
    config.vis = "json"
    train_cli.save_config(config)
    train_cli.train_loop(config, device="cpu")
    return out


@pytest.fixture(scope="module")
def run_trainer(run_dir):
    """The run directory's trainer, as the script rebuilds it."""
    return eval_setup(run_dir, device="cpu")[0]


@pytest.mark.parametrize("traj", ("orbit", "spiral", "interpolate", "filename"))
def test_render_script_frames_equal_image_renderer(run_dir, run_trainer, tmp_path, traj):
    args = ["--traj", traj, "--num-frames", "1", "--width", "24", "--height", "16",
            "--output", str(tmp_path / "frames")]
    if traj == "filename":
        (tmp_path / "path.json").write_text(json.dumps(_path_json(n=2)))
        args += ["--camera-path-filename", str(tmp_path / "path.json")]
    assert render_script.main([str(run_dir)] + args, device="cpu") == 0
    trainer = run_trainer
    parsed = render_script.argparse.Namespace(
        traj=traj, num_frames=1, width=24, height=16, orbit_radius=1.5, fov_deg=60.0,
        camera_path_filename=str(tmp_path / "path.json"))
    cams = render_script.path_cameras(parsed, trainer)
    renderer = ImageRenderer(trainer.model)
    frames = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(frames) == cams.camera_to_worlds.shape[0] == (2 if traj == "filename" else 1)
    for i, f in enumerate(frames):
        rgb = renderer.render_image(cams, i)["rgb"]
        want = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(f)), want)
    assert np.asarray(Image.open(frames[0])).shape == (cams.height, cams.width, 3)


def test_render_script_needs_cuda_by_default(run_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert render_script.main([str(run_dir)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
