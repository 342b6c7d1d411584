"""The port's dataparser families and format routing against the JAX
package, on the CPU.

Each family parses the scene that ``tests/test_dataparsers_extra.py`` and
``tests/test_colmap.py`` write for the JAX parser (ARKitScenes, which has
no JAX test, gets a two-frame trajectory here), and the port must give
the same outputs: cameras (poses, intrinsics, size), filenames, scene box,
scale and transform, masks and per-frame times, bit for bit (the same
numpy arithmetic, cast to f32 once).  ``_detect_parser`` and the
``DataManager`` route Blender, instant-ngp and nerfstudio directories as
JAX's do, and a Blender and an instant-ngp scene train.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.data import datamanager as jdm
from samnerf_tpu.data import dataparser as jdp
from samnerf_tpu.data import dataparsers_extra as jpe
from samnerf_tpu_torch.data import datamanager as tdm
from samnerf_tpu_torch.data import dataparser as tdp
from samnerf_tpu_torch.data import dataparsers_extra as tpe
from samnerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
from samnerf_tpu_torch.utils import synthetic

from test_colmap import _write_binary_model
from test_dataparsers_extra import _pose
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


def _assert_outputs(ours, ref):
    assert ours.image_filenames == ref.image_filenames
    oc, rc = ours.cameras, ref.cameras
    assert (oc.width, oc.height) == (int(rc.width), int(rc.height))
    for k in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        a, b = getattr(oc, k), np.asarray(getattr(rc, k))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert oc.distortion_params is None and rc.distortion_params is None
    np.testing.assert_array_equal(ours.scene_box_aabb, ref.scene_box_aabb)
    assert ours.dataparser_scale == ref.dataparser_scale
    np.testing.assert_array_equal(ours.dataparser_transform, ref.dataparser_transform)
    assert ours.mask_filenames == ref.mask_filenames


def _blender(root, with_images=False, time=False, n=4):
    root.mkdir(parents=True, exist_ok=True)
    for split in ("train", "test"):
        frames = [{"file_path": f"./{split}/r_{i}", "transform_matrix": _pose(i)}
                  for i in range(n)]
        if time:
            for i, f in enumerate(frames):
                f["time"] = i / 3.0
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.7, "frames": frames}))
        if with_images:
            (root / split).mkdir(exist_ok=True)
            rng = np.random.default_rng(0)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)).save(
                    root / split / f"r_{i}.png")
    return root


def _instant_ngp(root, with_images=False, n=3, angle=False):
    """``angle``: the field of view as ``camera_angle_x`` instead of
    ``fl_x`` / ``fl_y``, the form the routing sends to this parser."""
    root.mkdir(parents=True, exist_ok=True)
    meta = {"fl_x": 400.0, "fl_y": 410.0, "cx": 320.0, "cy": 240.0, "h": 480, "w": 640,
            "aabb_scale": 4,
            "frames": [{"file_path": f"images/{i}.png", "transform_matrix": _pose(i)}
                       for i in range(n)]}
    if angle:
        del meta["fl_x"], meta["fl_y"]
        meta["camera_angle_x"] = 0.9
    if with_images:
        meta.update(cx=16.0, cy=12.0, h=24, w=32)
        (root / "images").mkdir(exist_ok=True)
        rng = np.random.default_rng(1)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(
                root / "images" / f"{i}.png")
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def _minimal(root):
    poses = np.stack([np.eye(4)[:3].astype(np.float32)] * 2)
    np.savez(root / "train.npz", poses=poses, image_filenames=np.array(["a.png", "b.png"]),
             fx=100.0, fy=100.0, cx=32.0, cy=32.0, height=64, width=64)
    return root


def _phototourism_text(root):
    (root / "cameras.txt").write_text("1 PINHOLE 64 48 50.0 51.0 32.0 24.0\n")
    (root / "images.txt").write_text(
        "1 1 0 0 0 0.0 0.0 1.0 1 img.png\n\n2 1 0 0 0 0.0 0.0 2.0 1 i2.png\n\n")
    return root


def _phototourism_binary(root):
    recon = root / "dense" / "sparse"
    recon.mkdir(parents=True)
    _write_binary_model(recon)
    return root


def _sdfstudio(root):
    meta = {"height": 48, "width": 64,
            "frames": [{"rgb_path": f"rgb/{i}.png", "camtoworld": _pose(i),
                        "intrinsics": [[50, 0, 32, 0], [0, 50, 24, 0], [0, 0, 1, 0],
                                       [0, 0, 0, 1]]} for i in range(2)]}
    (root / "meta_data.json").write_text(json.dumps(meta))
    return root


def _scannet(root):
    for d in ("intrinsic", "pose", "color"):
        (root / d).mkdir()
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", np.eye(4) * 500)
    for i in range(2):
        np.savetxt(root / "pose" / f"{i}.txt", np.array(_pose(i)))
    return root


def _arkitscenes(root):
    (root / "lowres_wide_intrinsics").mkdir()
    lines = []
    for i, ts in enumerate(("100.000", "100.500", "101.000")):
        lines.append(f"{ts} 0.1 {0.2 * i} -0.05 {i * 0.3} 0.1 1.5")
        if i < 2:                                # the last frame has no intrinsics
            (root / "lowres_wide_intrinsics" / f"{ts}.pincam").write_text(
                f"256 192 {210 + i} {211 + i} 128.5 96.5")
    lines.append("bad line")
    (root / "lowres_wide.traj").write_text("\n".join(lines))
    return root


def _dycheck(root):
    (root / "camera").mkdir()
    ids = ["0_00000", "0_00001"]
    (root / "dataset.json").write_text(json.dumps({"train_ids": ids}))
    (root / "metadata.json").write_text(json.dumps({"0_00001": {"time_id": 4}}))
    for i, name in enumerate(ids):
        cam = {"orientation": np.eye(3).tolist(), "position": [0, 0, 1 + i],
               "focal_length": 100.0, "principal_point": [32, 24], "image_size": [64, 48]}
        (root / "camera" / f"{name}.json").write_text(json.dumps(cam))
    return root


def _sitcoms3d(root):
    meta = {"frames": [{"intrinsics": [[100, 0, 64], [0, 100, 48], [0, 0, 1]],
                        "camtoworld": _pose(i), "image_name": f"f{i}.png"} for i in range(2)],
            "aabb": [[-2, -2, -2], [2, 2, 2]]}
    (root / "cameras.json").write_text(json.dumps(meta))
    return root


def _nuscenes(root, n=10):
    tdir = root / "v1.0-mini"
    tdir.mkdir()
    samples, sample_data, ego, calib = [], [], [], []
    for i in range(n):
        samples.append({"token": f"s{i}", "scene_token": "sc0", "timestamp": 1000 + i})
        ego.append({"token": f"e{i}", "rotation": [1.0, 0.0, 0.0, 0.1 * i],
                    "translation": [float(i), 0.2 * i, 1.5]})
        calib.append({"token": f"c{i}", "sensor_token": "se0",
                      "rotation": [0.5, -0.5, 0.5, -0.5], "translation": [1.5, 0.0, 1.6],
                      "camera_intrinsic": [[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0],
                                           [0.0, 0.0, 1.0]]})
        sample_data.append({"token": f"sd{i}", "sample_token": f"s{i}",
                            "ego_pose_token": f"e{i}", "calibrated_sensor_token": f"c{i}",
                            "is_key_frame": True,
                            "filename": f"samples/CAM_FRONT/img_{i}.jpg"})
    tables = {"scene": [{"token": "sc0", "name": "scene-0001"}], "sample": samples,
              "sample_data": sample_data, "ego_pose": ego, "calibrated_sensor": calib,
              "sensor": [{"token": "se0", "channel": "CAM_FRONT", "modality": "camera"}]}
    for name, rows in tables.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))
    return root


FAMILIES = {
    "blender": (_blender, "parse_blender_data", "BlenderDataparserConfig", {}),
    "instant_ngp": (_instant_ngp, "parse_instant_ngp_data", "InstantNGPDataparserConfig", {}),
    "minimal": (_minimal, "parse_minimal_data", "MinimalDataparserConfig", {}),
    "phototourism_text": (_phototourism_text, "parse_phototourism_data",
                          "PhototourismDataparserConfig", {}),
    "phototourism_binary": (_phototourism_binary, "parse_phototourism_data",
                            "PhototourismDataparserConfig", {}),
    "sdfstudio": (_sdfstudio, "parse_sdfstudio_data", "SDFStudioDataparserConfig", {}),
    "scannet": (_scannet, "parse_scannet_data", "ScanNetDataparserConfig", {}),
    "arkitscenes": (_arkitscenes, "parse_arkitscenes_data", "ARKitScenesDataparserConfig", {}),
    "sitcoms3d": (_sitcoms3d, "parse_sitcoms3d_data", "Sitcoms3DDataparserConfig", {}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax(family, tmp_path):
    write, fn, cfg, kw = FAMILIES[family]
    root = tmp_path / family
    root.mkdir()
    write(root)
    ours = getattr(tpe, fn)(getattr(tpe, cfg)(data=root, **kw), "train")
    ref = getattr(jpe, fn)(getattr(jpe, cfg)(data=root, **kw), "train")
    _assert_outputs(ours, ref)
    assert ours.cameras.num_cameras >= 1


@pytest.mark.parametrize("family", ("dnerf", "dycheck"))
def test_timed_family_matches_jax(family, tmp_path):
    if family == "dnerf":
        root = _blender(tmp_path / "dnerf", time=True)
        args = ("parse_dnerf_data", "DNeRFDataparserConfig")
    else:
        root = tmp_path / "dycheck"
        root.mkdir()
        _dycheck(root)
        args = ("parse_dycheck_data", "DycheckDataparserConfig")
    ours, times = getattr(tpe, args[0])(getattr(tpe, args[1])(data=root), "train")
    ref, jtimes = getattr(jpe, args[0])(getattr(jpe, args[1])(data=root), "train")
    _assert_outputs(ours, ref)
    assert times.dtype == np.float32
    np.testing.assert_array_equal(times, jtimes)
    assert times.max() == 1.0


@pytest.mark.parametrize("split", ("train", "test"))
@pytest.mark.parametrize("masks", (False, True))
def test_nuscenes_matches_jax(tmp_path, split, masks):
    root = _nuscenes(tmp_path)
    kw = dict(data="scene-0001", data_dir=root, version="v1.0-mini",
              mask_dir=tmp_path / "m" if masks else None)
    ours = tpe.parse_nuscenes_data(tpe.NuScenesDataparserConfig(**kw), split)
    ref = jpe.parse_nuscenes_data(jpe.NuScenesDataparserConfig(**kw), split)
    _assert_outputs(ours, ref)
    assert ours.cameras.num_cameras == (9 if split == "train" else 1)
    assert (ours.mask_filenames is not None) == masks


def test_registry_names_match_jax():
    assert set(tpe.dataparser_registry) == set(jpe.dataparser_registry)
    assert tpe.dataparser_registry["nerfstudio-data"] is tdp.parse_nerfstudio_data


def test_family_config_carries_shared_fields(tmp_path):
    dp = tdp.DataparserConfig(data=tmp_path, scale_factor=0.5, scene_scale=2.0)
    jcfg = jdm._family_config(jpe.InstantNGPDataparserConfig, jdp.DataparserConfig(
        data=tmp_path, scale_factor=0.5, scene_scale=2.0))
    assert dataclasses.asdict(tdm._family_config(tpe.InstantNGPDataparserConfig, dp)) == \
        dataclasses.asdict(jcfg) == {"data": tmp_path, "scene_scale": 2.0}
    assert tdm._family_config(tpe.BlenderDataparserConfig, dp).scale_factor == 0.5


def test_instant_ngp_focal_from_the_field_of_view(tmp_path):
    """Queue C (n): the JAX parser reads only ``fl_x`` / ``fl_y`` (a
    ``KeyError`` without them); the port takes the field of view, as
    nerfstudio's instant-ngp parser does."""
    root = _instant_ngp(tmp_path / "ngp", angle=True)
    with pytest.raises(KeyError):
        jpe.parse_instant_ngp_data(jpe.InstantNGPDataparserConfig(data=root), "train")
    out = tpe.parse_instant_ngp_data(tpe.InstantNGPDataparserConfig(data=root), "train")
    f = np.float32(640 / (2 * np.tan(0.45)))
    np.testing.assert_array_equal(out.cameras.fx.numpy(), np.full((3, 1), f))
    np.testing.assert_array_equal(out.cameras.fy.numpy(), np.full((3, 1), f))
    assert tpe.instant_ngp_focal_lengths({"x_fov": 90.0, "y_fov": 60.0, "w": 200, "h": 100}) \
        == pytest.approx((100.0, 50.0 / np.tan(np.pi / 6)))
    with pytest.raises(KeyError, match="focal"):
        tpe.instant_ngp_focal_lengths({"w": 2, "h": 2})


@pytest.mark.parametrize("layout", ("blender", "instant_ngp", "instant_ngp_fl_x",
                                    "nerfstudio", "broken_json"))
def test_detect_parser_routes_as_jax(tmp_path, layout):
    """Blender goes to its parser in both packages; an instant-ngp file
    with ``aabb_scale`` and no ``fl_x`` to the instant-ngp parser (whose
    JAX version then needs the ``fl_x`` it routed on: Queue C (n)); one
    with ``fl_x``, a nerfstudio scene and unreadable JSON to the nerfstudio
    parser."""
    root = tmp_path / layout
    if layout == "blender":
        _blender(root)
    elif layout == "instant_ngp":
        _instant_ngp(root, angle=True)
    elif layout == "instant_ngp_fl_x":
        _instant_ngp(root, with_images=True)
    elif layout == "nerfstudio":
        synthetic.write_scene(root, num_train=3, num_test=1, h=16, w=16)
    else:
        root.mkdir()
        (root / "transforms.json").write_text("{not json")
    ours = tdm._detect_parser(tdp.DataparserConfig(data=root))
    ref = jdm._detect_parser(jdp.DataparserConfig(data=root))
    if layout in ("nerfstudio", "instant_ngp_fl_x"):
        assert ours is tdp.parse_nerfstudio_data and ref is jdp.parse_nerfstudio_data
        cfg = dict(data=root, train_val_json_split=layout == "nerfstudio")
        _assert_outputs(ours(tdp.DataparserConfig(**cfg), "train"),
                        ref(jdp.DataparserConfig(**cfg), "train"))
    elif layout == "broken_json":
        assert ours is tdp.parse_nerfstudio_data and ref is jdp.parse_nerfstudio_data
    elif layout == "instant_ngp":
        assert ours is not tdp.parse_nerfstudio_data and ref is not jdp.parse_nerfstudio_data
        with pytest.raises(KeyError):
            ref(jdp.DataparserConfig(data=root), "train")
        out = ours(tdp.DataparserConfig(data=root, scene_scale=0.5), "train")
        np.testing.assert_array_equal(out.scene_box_aabb, [[-2] * 3, [2] * 3])
        assert out.dataparser_scale == 0.5                  # carried over by name
    else:
        for split in ("train", "test"):
            _assert_outputs(ours(tdp.DataparserConfig(data=root), split),
                            ref(jdp.DataparserConfig(data=root), split))


@pytest.mark.parametrize("layout", ("blender", "instant_ngp"))
def test_family_scene_trains(tmp_path, layout):
    """A Blender scene (RGBA images over white) and an instant-ngp scene,
    routed by the DataManager, train two steps without distillation."""
    if layout == "blender":
        root = _blender(tmp_path / layout, with_images=True)
    else:
        root = _instant_ngp(tmp_path / layout, with_images=True, angle=True)
    dp = tdp.DataparserConfig(data=root)
    dm = tdm.DataManager(tdm.DataManagerConfig(dataparser=dp, train_num_rays_per_batch=64))
    assert dm.images.shape[1:] == (24, 32, 3)
    if layout == "blender":
        jd = jdm.DataManager(jdm.DataManagerConfig(dataparser=jdp.DataparserConfig(data=root)))
        np.testing.assert_array_equal(dm.images, jd.images)
        np.testing.assert_array_equal(dm.cameras.camera_to_worlds.numpy(),
                                      np.asarray(jd.cameras.camera_to_worlds))
    else:      # the instant-ngp parser's flips, at the DataparserConfig's scene_scale 1
        c2w = dm.cameras.camera_to_worlds.numpy()
        np.testing.assert_array_equal(c2w[1, :, 1], [0, -1, 0])
        np.testing.assert_allclose(c2w[1, 0, 3], 0.1, rtol=1e-6)
    cfg = dataclasses.replace(TINY, distill_sam=False, use_clipseg_feature=False)
    trainer = Trainer(cfg, TrainerConfig(max_num_iterations=2, steps_per_save=100000,
                                         steps_per_eval_batch=0, steps_per_eval_image=0,
                                         output_dir=tmp_path / "out"),
                      {k: v for k, v in GROUPS.items() if k in ("proposal_networks", "fields")},
                      dm, device="cpu")
    losses = []
    trainer.train(step_callback=lambda s, m: losses.append(float(m["rgb_loss"])))
    assert len(losses) == 2 and np.isfinite(losses).all()
