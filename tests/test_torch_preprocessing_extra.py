"""The port's host-side data preparation against the JAX package's, on the
CPU: COLMAP models (binary and text, every camera model the converter
takes), ``colmap_to_json``, the LLFF converter, the Polycam, Record3D,
Metashape and RealityCapture converters, the process-data helpers and
the equirectangular crops.  Both packages run the same numpy arithmetic,
so every output is held equal: the same ``transforms.json`` objects, the
same images, byte for byte.  External tools (hloc, ffmpeg) are not
installed here: the port builds their arguments and raises a clear error.
"""
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from samnerf_tpu.preprocessing import colmap_utils as jcu
from samnerf_tpu.preprocessing import converters as jconv
from samnerf_tpu.preprocessing import equirect_utils as jeq
from samnerf_tpu.preprocessing import llff2nerf as jllff
from samnerf_tpu.preprocessing import process_data_utils as jpdu
from samnerf_tpu_torch.preprocessing import colmap_utils as tcu
from samnerf_tpu_torch.preprocessing import converters as tconv
from samnerf_tpu_torch.preprocessing import equirect_utils as teq
from samnerf_tpu_torch.preprocessing import llff2nerf as tllff
from samnerf_tpu_torch.preprocessing import process_data_utils as tpdu

from test_colmap import _write_binary_model

MODELS = {  # id: (name, params)
    0: ("SIMPLE_PINHOLE", [50.0, 32.0, 24.0]),
    1: ("PINHOLE", [400.0, 410.0, 320.0, 240.0]),
    2: ("SIMPLE_RADIAL", [50.0, 32.0, 24.0, 0.01]),
    3: ("RADIAL", [50.0, 32.0, 24.0, 0.01, -0.002]),
    4: ("OPENCV", [50.0, 51.0, 32.0, 24.0, 0.01, -0.002, 0.001, 0.0005]),
    5: ("OPENCV_FISHEYE", [50.0, 51.0, 32.0, 24.0, 0.01, -0.002, 0.001, 0.0005]),
}


def _write_model(d, model_id):
    """A binary COLMAP model: one camera of ``model_id``, three images with
    rotated poses and 2D points to skip."""
    rng = np.random.default_rng(model_id)
    _, params = MODELS[model_id]
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 3, model_id, 64, 48))
        f.write(struct.pack(f"<{len(params)}d", *params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid in (5, 2, 9):
            q = rng.normal(size=4)
            f.write(struct.pack("<I", iid))
            f.write(struct.pack("<4d", *(q / np.linalg.norm(q))))
            f.write(struct.pack("<3d", *rng.normal(size=3)))
            f.write(struct.pack("<I", 3))
            f.write(f"im_{iid}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<3d", 1.0, 2.0, 3.0) * 2)


def _same_records(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ours:
        a, b = ours[k].__dict__, ref[k].__dict__
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)


def _same_json(a: Path, b: Path):
    assert json.loads(a.read_text()) == json.loads(b.read_text())


@pytest.mark.parametrize("model_id", sorted(MODELS))
def test_colmap_binary_model_and_json_match_jax(tmp_path, model_id):
    _write_model(tmp_path, model_id)
    _same_records(tcu.read_cameras_binary(tmp_path / "cameras.bin"),
                  jcu.read_cameras_binary(tmp_path / "cameras.bin"))
    _same_records(tcu.read_images_binary(tmp_path / "images.bin"),
                  jcu.read_images_binary(tmp_path / "images.bin"))
    assert tcu.colmap_to_json(tmp_path, tmp_path / "ours") == \
        jcu.colmap_to_json(tmp_path, tmp_path / "ref") == 3
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


def test_colmap_text_model_and_json_match_jax(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 OPENCV 64 48 50.0 51.0 32.0 24.0 0.01 -0.002 0.001 0.0005\n")
    (tmp_path / "images.txt").write_text(
        "# header\n1 1 0 0 0 0.5 0.5 0.5 1 img.png\n\n"
        "2 0.9 0.1 0.3 0.2 0.1 -0.2 2.0 1 b.png\n1.0 2.0 -1\n")
    _same_records(tcu.read_cameras_text(tmp_path / "cameras.txt"),
                  jcu.read_cameras_text(tmp_path / "cameras.txt"))
    _same_records(tcu.read_images_text(tmp_path / "images.txt"),
                  jcu.read_images_text(tmp_path / "images.txt"))
    assert tcu.colmap_to_json(tmp_path, tmp_path / "ours", "imgs") == 2
    jcu.colmap_to_json(tmp_path, tmp_path / "ref", "imgs")
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


def test_colmap_json_of_the_jax_fixture_loads_with_distortion(tmp_path):
    """``tests/test_colmap.py``'s binary model through the port, then its
    ``transforms.json`` through the port's nerfstudio parser."""
    from samnerf_tpu_torch.data.dataparser import DataparserConfig, parse_nerfstudio_data

    _write_binary_model(tmp_path)
    tcu.colmap_to_json(tmp_path, tmp_path)
    out = parse_nerfstudio_data(DataparserConfig(data=tmp_path, train_split_fraction=0.5))
    assert out.cameras.num_cameras == 1 and float(out.cameras.fx[0, 0]) == 400.0
    with pytest.raises(ValueError, match="FOV"):
        tcu._intrinsics(tcu.ColmapCamera("FOV", 4, 4, np.zeros(5)))


def _llff(root, n=7):
    """An LLFF capture on a tilted ring (the averaged up vector is far from
    +z, so the alignment is well conditioned)."""
    (root / "images_4").mkdir(parents=True)
    for i in range(n):
        Image.new("RGB", (40, 30)).save(root / "images_4" / f"im_{i:03d}.png")
    pb = np.zeros((n, 17))
    tilt = np.array([[1, 0, 0], [0, np.cos(0.7), -np.sin(0.7)], [0, np.sin(0.7), np.cos(0.7)]])
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = tilt @ np.array([2 * np.cos(ang), 2 * np.sin(ang), 0.3])
        z = pos / np.linalg.norm(pos)
        x = np.cross(tilt @ np.array([0.0, 0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        pose = np.concatenate([np.stack([-y, x, z], -1), pos[:, None],
                               np.array([[120.0], [160.0], [150.0]])], axis=1)
        pb[i, :15] = pose.flatten()
        pb[i, 15:] = [1.0, 10.0]
    np.save(root / "poses_bounds.npy", pb)
    return root


def test_llff_converter_matches_jax(tmp_path):
    ours, ref = _llff(tmp_path / "ours"), _llff(tmp_path / "ref")
    tllff.main([str(ours), "--images", "images_4", "--downscale", "4", "--hold", "3"])
    jllff.convert_llff(ref, images_dir="images_4", downscale=4, hold=3)
    for split in ("train", "val", "test"):
        a = json.loads((ours / f"transforms_{split}.json").read_text())
        b = json.loads((ref / f"transforms_{split}.json").read_text())
        assert {k: v for k, v in a.items() if k != "frames"} == \
            {k: v for k, v in b.items() if k != "frames"}
        assert [f["file_path"] for f in a["frames"]] == [f["file_path"] for f in b["frames"]]
        np.testing.assert_allclose([f["transform_matrix"] for f in a["frames"]],
                                   [f["transform_matrix"] for f in b["frames"]],
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tllff.rotmat(np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
                               jllff.rotmat(np.array([1.0, 0, 0]), np.array([0, 1.0, 0])))


def _polycam(root):
    (root / "cameras").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i, blur in enumerate((40.0, 10.0, 80.0)):
        c = {f"t_{r}{k}": float(v) for r in range(3) for k, v in
             enumerate(rng.normal(size=4))}
        c.update(fx=200.0 + i, fy=201.0, cx=64.0, cy=48.0, width=128, height=96,
                 blur_score=blur)
        (root / "cameras" / f"{i:04d}.json").write_text(json.dumps(c))
    return root


def test_polycam_matches_jax(tmp_path):
    src = _polycam(tmp_path / "src")
    assert tconv.polycam_to_json(src, tmp_path / "ours") == \
        jconv.polycam_to_json(src, tmp_path / "ref") == 2
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


def test_record3d_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    poses = np.concatenate([rng.normal(size=(3, 4)), rng.normal(size=(3, 3))], -1)
    meta = {"K": [300.0, 0, 0, 0, 310.0, 0, 96.0, 128.0, 1.0], "poses": poses.tolist(),
            "w": 192}
    (tmp_path / "metadata.json").write_text(json.dumps(meta))
    assert tconv.record3d_to_json(tmp_path / "metadata.json", tmp_path / "ours") == 3
    jconv.record3d_to_json(tmp_path / "metadata.json", tmp_path / "ref")
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


METASHAPE = """<document><chunk>
  <sensors>
    <sensor id="0"><resolution width="640" height="480"/>
      <calibration><f>500.0</f><cx>2.0</cx><cy>-3.0</cy><k1>0.01</k1><p2>0.003</p2>
      </calibration></sensor>
    <sensor id="1"><resolution width="10" height="10"/></sensor>
  </sensors>
  <cameras>
    <camera id="0" sensor_id="0" label="img_a.jpg">
      <transform>0 1 0 0.5 -1 0 0 0.25 0 0 1 2.0 0 0 0 1</transform>
    </camera>
    <camera id="1" sensor_id="0" label="img_b"/>
    <camera id="2" sensor_id="1" label="img_c"><transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform></camera>
    <camera id="3" sensor_id="0" label="img_x"/>
  </cameras>
</chunk></document>"""


def test_metashape_matches_jax(tmp_path):
    (tmp_path / "cameras.xml").write_text(METASHAPE)
    names = {k: Path(f"images/{k}.jpg") for k in ("img_a", "img_b", "img_c")}
    for out in ("ours", "ref"):
        (tmp_path / out).mkdir()
    ours = tconv.metashape_to_json(names, tmp_path / "cameras.xml", tmp_path / "ours")
    ref = jconv.metashape_to_json(names, tmp_path / "cameras.xml", tmp_path / "ref")
    assert ours == ref and "2 images skipped" in ours[0]
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


def test_realitycapture_matches_jax(tmp_path):
    csv_text = ("#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
                "shot1.jpg,1.0,2.0,3.0,90.0,10.0,-5.0,36.0,0.5,-0.5,0.01,0,0,0,0,0\n"
                "shot2.jpg,0.0,1.0,2.0,45.0,0.0,0.0,28.0,0.0,0.0,0,0,0,0,0,0\n"
                "missing.jpg,0,0,0,0,0,0,30,0,0,0,0,0,0,0,0\n")
    (tmp_path / "poses.csv").write_text(csv_text)
    names = {"shot1": Path("images/shot1.jpg"), "shot2": Path("images/shot2.jpg")}
    (tmp_path / "ours" / "images").mkdir(parents=True)
    (tmp_path / "ref" / "images").mkdir(parents=True)
    for out in ("ours", "ref"):
        Image.new("RGB", (64, 48)).save(tmp_path / out / "images" / "shot1.jpg")
    ours = tconv.realitycapture_to_json(names, tmp_path / "poses.csv", tmp_path / "ours")
    ref = jconv.realitycapture_to_json(names, tmp_path / "poses.csv", tmp_path / "ref")
    assert ours == ref and "Missing image data for 1" in ours[0]
    _same_json(tmp_path / "ours" / "transforms.json", tmp_path / "ref" / "transforms.json")


def test_quaternion_and_euler_helpers_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        q = rng.normal(size=4)
        np.testing.assert_array_equal(tconv._quat_to_rot(*q), jconv._quat_to_rot(*q))
        e = rng.uniform(-180, 180, 3)
        np.testing.assert_array_equal(tconv._euler_to_rot(*e), jconv._euler_to_rot(*e))


def test_hloc_arguments_and_missing_toolbox(tmp_path):
    (tmp_path / "imgs").mkdir()
    for i in range(3):
        (tmp_path / "imgs" / f"{i}.jpg").write_bytes(b"")
    plan = tconv.hloc_plan(tmp_path / "imgs", tmp_path / "colmap", num_matched=50)
    assert plan["num_matched"] == 3
    assert plan["sfm_dir"] == tmp_path / "colmap" / "sparse" / "0"
    assert plan["sfm_pairs"] == tmp_path / "colmap" / "pairs-netvlad.txt"
    assert (plan["retrieval_conf"], plan["feature_conf"], plan["matcher_conf"]) == \
        ("netvlad", "superpoint_aachen", "superglue")
    with pytest.raises(ImportError, match="hloc"):
        tconv.run_hloc(tmp_path / "imgs", tmp_path / "colmap")


def test_process_data_utils_match_jax(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    for i in range(7):
        Image.fromarray(np.full((32, 48, 3), i * 30, np.uint8)).save(src / f"im{i}.png")
    (src / "notes.txt").write_text("skip me")
    assert tpdu.list_images(src) == jpdu.list_images(src)
    for m in (-1, 3, 7, 10):
        assert tpdu.get_image_filenames(src, m) == jpdu.get_image_filenames(src, m)
    for name, mod in (("ours", tpdu), ("ref", jpdu)):
        mapping = mod.copy_images(src, tmp_path / name / "images")
        assert [p.name for p in mapping.values()][:2] == ["frame_00001.png", "frame_00002.png"]
        assert mod.downscale_images(tmp_path / name / "images", 2) == \
            "We downsampled the images by 2x, 4x"
        mod.copy_images_list(tpdu.list_images(src)[:2], tmp_path / name / "cropped",
                             crop_border_pixels=3)
    for sub in ("images", "images_2", "images_4", "cropped"):
        a = sorted((tmp_path / "ours" / sub).iterdir())
        b = sorted((tmp_path / "ref" / sub).iterdir())
        assert [p.name for p in a] == [p.name for p in b]
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))
    for args in ((100, 100, 1.0), (60, 80, 0.5), (10, 10, 1.5)):
        a, b = tpdu.generate_circle_mask(*args), jpdu.generate_circle_mask(*args)
        assert (a is None and b is None) or np.array_equal(a, b)
    for crop in ((0.1, 0.1, 0.0, 0.0), (0.0, 0.2, 0.3, 0.1), (0.0, 0.0, 0.0, 0.0)):
        a, b = tpdu.generate_crop_mask(50, 40, crop), jpdu.generate_crop_mask(50, 40, crop)
        assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(ValueError):
        tpdu.generate_crop_mask(4, 4, (1.5, 0, 0, 0))


def test_video_commands_and_missing_ffmpeg(tmp_path, monkeypatch):
    cmd = tpdu.ffmpeg_extract_command(Path("v.mp4"), tmp_path, 300, 30, (0.1, 0.0, 0.0, 0.2))
    assert cmd == ["ffmpeg", "-i", "v.mp4", "-vf",
                   "thumbnail=10,setpts=N/TB,crop=w=iw*(1-0.0-0.2):h=ih*(1-0.1-0.0)"
                   ":x=iw*0.0:y=ih*0.1", "-r", "1", str(tmp_path / "frame_%05d.png")]
    assert tpdu.ffmpeg_extract_command(Path("v.mp4"), tmp_path, 10, 30)[4] == \
        "thumbnail=1,setpts=N/TB"
    assert tpdu.ffprobe_frame_count_command(Path("v.mp4"))[-1] == "v.mp4"
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tpdu.convert_video_to_images(tmp_path / "v.mp4", tmp_path / "f", 5)
    assert tpdu.get_num_frames_in_video(tmp_path / "v.mp4") == -1


def _pano():
    ph, pw = 64, 128
    lon = (np.arange(pw) + 0.5) / pw
    lat = (np.arange(ph) + 0.5) / ph
    pano = np.zeros((ph, pw, 3), np.float32)
    pano[..., 0] = lon[None, :]
    pano[..., 1] = lat[:, None]
    pano[..., 2] = np.random.default_rng(6).uniform(size=(ph, pw))
    return pano


@pytest.mark.parametrize("fov,yaw,pitch,hw", [(90.0, 0.0, 0.0, (32, 32)),
                                             (60.0, 2.5, -0.4, (24, 40)),
                                             (120.0, -1.0, 1.2, (20, 20))])
def test_equirect_to_perspective_matches_jax(fov, yaw, pitch, hw):
    pano = _pano()
    for p in (pano, (pano * 255).astype(np.uint8)):
        np.testing.assert_array_equal(teq.equirect_to_perspective(p, fov, yaw, pitch, hw),
                                      jeq.equirect_to_perspective(p, fov, yaw, pitch, hw))


def test_planar_projections_match_jax(tmp_path):
    for name in ("ours", "ref"):
        d = tmp_path / name
        d.mkdir()
        Image.fromarray((_pano() * 255).astype(np.uint8)).save(d / "pano.png")
        (d / "readme.txt").write_text("not an image")
    a = teq.generate_planar_projections_from_equirectangular(tmp_path / "ours", (24, 16), 5,
                                                             percent_crop=(0.1, 0.2, 0, 0))
    b = jeq.generate_planar_projections_from_equirectangular(tmp_path / "ref", (24, 16), 5,
                                                             percent_crop=(0.1, 0.2, 0, 0))
    assert json.loads((a / "projections.json").read_text()) == \
        json.loads((b / "projections.json").read_text())
    crops = sorted(a.glob("*.png"))
    assert len(crops) == 5
    for p in crops:
        np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(b / p.name)))
    assert teq.compute_resolution_from_equirect(tmp_path / "ours", 8) == \
        jeq.compute_resolution_from_equirect(tmp_path / "ref", 8)
