"""The port's feature-extraction entry point against the JAX package's on
the CPU: a two-image scene, one wide and one tall image, through
``get_image_embeddings`` of both packages with one reference-layout
checkpoint that the port writes.  Both registries' ``vit_h`` spec is
patched here, and only here, to the tiny encoder (embed 40, depth 3,
2 heads, global layer 1) at the real 1024 input, window 14 and 256-channel
neck, so the crops to each image's aspect are the real ones.

Tolerance: rtol 1e-4 / atol 1e-4 (f32 sums in another order through three
blocks over 64x64 tokens and the neck, whose LayerNorm2d makes the
features O(1)).
"""
import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.perception.sam import build_sam as jax_build_sam
from samnerf_tpu.preprocessing import get_image_embeddings as jax_entry
from samnerf_tpu_torch.data.feature_loader import load_features
from samnerf_tpu_torch.perception.sam import build_sam as torch_build_sam
from samnerf_tpu_torch.preprocessing import get_image_embeddings as torch_entry
from samnerf_tpu_torch.utils.init import init_state

TINY_SPEC = dict(embed_dim=40, depth=3, num_heads=2, global_attn_indexes=(1,))
SIZES = {"wide": (60, 100), "tall": (100, 60)}


@pytest.fixture
def tiny_registries(monkeypatch):
    monkeypatch.setitem(jax_build_sam._VIT_SPECS, "vit_h", TINY_SPEC)
    monkeypatch.setitem(torch_build_sam._VIT_SPECS, "vit_h", TINY_SPEC)


def _scene(root):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    for name, (h, w) in SIZES.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{name}.png")
    (root / "images" / "notes.txt").write_text("not an image")
    return root


def test_entry_point_matches_jax(tmp_path, tiny_registries):
    ckpt = tmp_path / "sam_tiny.pth"
    meta = torch_build_sam.build_sam("vit_h", device="meta")
    torch.save(init_state(meta, torch.Generator().manual_seed(0), "cpu"), ckpt)

    ours, ref = _scene(tmp_path / "ours"), _scene(tmp_path / "ref")
    torch_entry.get_embeddings(ours, str(ckpt), device="cpu")
    jax_entry.main([str(ref), "--checkpoint", str(ckpt)])

    names = sorted(p.name for p in (ours / "sam_features").iterdir())
    assert names == ["tall.npy", "wide.npy"]
    assert sorted(p.name for p in (ref / "sam_features").iterdir()) == names
    for name, shape in (("wide", (256, 39, 64)), ("tall", (256, 64, 39))):
        a = np.load(ours / "sam_features" / f"{name}.npy")
        b = np.load(ref / "sam_features" / f"{name}.npy")
        assert a.dtype == np.float32 and a.shape == b.shape == shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    # the port's training data reads them as [n, h, w, 256] targets
    feats = load_features([ours / "sam_features" / "wide.npy"])
    assert feats.shape == (1, 39, 64, 256) and feats.dtype == np.float32
