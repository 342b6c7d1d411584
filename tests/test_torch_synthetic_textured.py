"""The port's textured synthetic scene against the JAX package's on the
CPU, byte for byte: every file ``write_textured_scene`` writes (PNG
images, ``sam_features/*.npy``, ``clipseg_features/*.pt``, both
``transforms_*.json``), the primary-sphere hit mask of
``render_gt_image_textured``, ``ray_sphere_hit`` with and without a
centre, and ``full_image_coords``.  Both packages run the same numpy
arithmetic, so nothing here has a tolerance.

The scene digests that ``chip_smoke.py`` checks on the card
(``SCENE_DIGESTS``: the first image's PNG bytes, its pixels and its
``.npy`` at the mIoU study's defaults) are computed here from the JAX
package's scene.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from samnerf_tpu.core.cameras import full_image_coords as jax_full_image_coords
from samnerf_tpu.utils import synthetic as jsyn
from samnerf_tpu_torch.core.cameras import full_image_coords
from samnerf_tpu_torch.utils import synthetic as tsyn

import chip_smoke

CASES = {
    "checker": dict(num_train=3, num_test=2, h=40, w=40, with_features=True, detail=2.0),
    "smooth_supersampled": dict(num_train=2, num_test=1, h=32, w=32, with_features=True,
                                detail=1.5, smooth_texture=True, supersample=2),
    "wide": dict(num_train=2, num_test=2, h=24, w=56, with_features=True,
                 feature_long_side=8, detail=4.0),
    "tall_no_features": dict(num_train=2, num_test=1, h=48, w=20),
}


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _same_scene(ours, ref):
    names = _files(ours)
    assert names == _files(ref)
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name
        if name.suffix == ".pt":
            d = torch.load(ours / name, weights_only=True)
            assert d["visual_q"] is None and len(d["activations"]) == 3
            assert all(tuple(a.shape) == (1025, 1, 64) for a in d["activations"])
    return names


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_textured_scene_matches_jax(tmp_path, case):
    kw = CASES[case]
    ours = tsyn.write_textured_scene(tmp_path / "ours", **kw)
    ref = jsyn.write_textured_scene(tmp_path / "ref", **kw)
    names = _same_scene(ours, ref)
    n = kw["num_train"] + kw["num_test"]
    assert sum(1 for p in names if p.suffix == ".png") == n
    assert any(p.suffix == ".npy" for p in names) == bool(kw.get("with_features"))
    meta = json.loads((ours / "transforms_train.json").read_text())
    assert meta["fl_x"] == 0.9 * kw["w"] and len(meta["frames"]) == kw["num_train"]


def test_write_scene_still_matches_jax(tmp_path):
    """The ball scene, whose feature writer the textured scene now shares."""
    kw = dict(num_train=2, num_test=1, h=24, w=40, with_features=True)
    _same_scene(tsyn.write_scene(tmp_path / "ours", **kw),
                jsyn.write_scene(tmp_path / "ref", **kw))


@pytest.mark.parametrize("smooth,supersample", [(False, 1), (True, 1), (True, 3)])
def test_render_gt_image_textured_and_hit_mask(smooth, supersample):
    c2w = tsyn.look_at_c2w(np.array([2.2, 0.4, 1.3]), np.array([0.0, 0.0, 0.25]))
    args = (c2w, 27.0, 27.0, 15.0, 12.0, 24, 30)
    kw = dict(detail=3.0, smooth_texture=smooth, supersample=supersample)
    img, hit = tsyn.render_gt_image_textured(*args, **kw)
    rimg, rhit = jsyn.render_gt_image_textured(*args, **kw)
    assert img.dtype == np.uint8 and img.shape == (24, 30, 3)
    assert hit.dtype == bool and hit.shape == (24, 30)
    np.testing.assert_array_equal(img, rimg)
    np.testing.assert_array_equal(hit, rhit)
    assert 0 < hit.sum() < hit.size      # the primary sphere is in view, not all of it


@pytest.mark.parametrize("center", [None, np.array([0.5, -0.3, 0.15])])
def test_ray_sphere_hit_matches_jax(center):
    rng = np.random.default_rng(3)
    origins = rng.normal(size=(256, 3)) * 2.0
    dirs = -origins + rng.normal(size=(256, 3)) * 0.3
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    hit, t = tsyn.ray_sphere_hit(origins, dirs, radius=0.4, center=center)
    rhit, rt = jsyn.ray_sphere_hit(origins, dirs, radius=0.4, center=center)
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_array_equal(t, rt)
    assert 0 < hit.sum() < 256


def test_ray_sphere_hit_default_centre_is_the_origin():
    """The existing callers (no ``center``) keep their results bit for bit."""
    rng = np.random.default_rng(4)
    origins = rng.normal(size=(128, 3)) * 2.0
    dirs = rng.normal(size=(128, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    hit, t = tsyn.ray_sphere_hit(origins, dirs)
    hit0, t0 = tsyn.ray_sphere_hit(origins, dirs, center=np.zeros(3))
    np.testing.assert_array_equal(hit, hit0)
    np.testing.assert_array_equal(t, t0)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (64, 48)])
def test_full_image_coords_matches_jax(h, w):
    ours, ref = full_image_coords(h, w), jax_full_image_coords(h, w)
    assert ours.dtype == np.float32 and ours.shape == (h * w, 2)
    np.testing.assert_array_equal(ours, ref)


def test_scene_digests_match_jax(tmp_path):
    """The mIoU study's scene (24 + 4 views, 256x256, detail 4, with
    features) from both packages: the digests ``chip_smoke.py`` checks."""
    kw = dict(num_train=24, num_test=4, h=256, w=256, with_features=True, detail=4.0)
    ref = jsyn.write_textured_scene(tmp_path / "ref", **kw)
    ours = tsyn.write_textured_scene(tmp_path / "ours", **kw)
    want = chip_smoke.scene_digests(ref)
    assert want == chip_smoke.SCENE_DIGESTS
    assert chip_smoke.scene_digests(ours) == want
    first = (ref / "images" / "frame_00000.png").read_bytes()
    assert want["png_sha256"] == hashlib.sha256(first).hexdigest()
