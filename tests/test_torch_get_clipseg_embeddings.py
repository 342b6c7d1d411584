"""The port's ClipSeg feature-extraction entry point against the JAX
package's on the CPU: a two-image scene (one wide, one tall image, and a
file that is not an image) through both ``get_clipseg_embeddings``
entry points with one pair of reference-layout checkpoints that the port
writes, the tiny CLIP of ``test_torch_clipseg.py`` patched into both
packages' pipeline modules.  The files hold the same dict, the
activations within rtol / atol 1e-5 (as ``reduced_activations`` there),
and the port's feature loader reads them into the trainer's 32x32x192
grids.
"""
import functools
import inspect

import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.perception.clipseg import clip_model as jcm
from samnerf_tpu.perception.clipseg import pipeline as jpipe
from samnerf_tpu.preprocessing import get_clipseg_embeddings as jax_entry
from samnerf_tpu_torch.data.feature_loader import clipseg_pt_to_grid, load_features
from samnerf_tpu_torch.perception.clipseg import clip_model as tcm
from samnerf_tpu_torch.perception.clipseg import clipseg as tcs
from samnerf_tpu_torch.perception.clipseg import pipeline as tpipe
from samnerf_tpu_torch.preprocessing import get_clipseg_embeddings as torch_entry

from test_torch_clipseg import EXTRACT, TINY_TEXT, TINY_VISUAL, write_tiny_checkpoints

SIZES = {"wide": (60, 100), "tall": (100, 60)}


@pytest.fixture
def tiny_clip(monkeypatch):
    """Both pipelines build the tiny CLIP and take its extract layers."""
    for mod, cm in ((jpipe, jcm), (tpipe, tcm)):
        monkeypatch.setattr(mod, "CLIPVisual", functools.partial(cm.CLIPVisual, **TINY_VISUAL))
        monkeypatch.setattr(mod, "CLIPText", functools.partial(cm.CLIPText, **TINY_TEXT))
    monkeypatch.setattr(tpipe, "CLIPDensePredT",
                        functools.partial(tcs.CLIPDensePredT, width=TINY_VISUAL["width"]))
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "ClipSegPredictor",
                            functools.partial(mod.ClipSegPredictor, extract_layers=EXTRACT))


def _scene(root):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    for name, (h, w) in SIZES.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{name}.png")
    (root / "images" / "notes.txt").write_text("not an image")
    return root


def test_entry_point_matches_jax(tmp_path, tiny_clip, monkeypatch):
    clip, decoder, _ = write_tiny_checkpoints(tmp_path)
    ours, ref = _scene(tmp_path / "ours"), _scene(tmp_path / "ref")
    args = ["--clipseg-checkpoint", str(decoder), "--clip-checkpoint", str(clip)]
    monkeypatch.setattr(torch_entry, "get_embeddings",
                        functools.partial(torch_entry.get_embeddings, device="cpu"))
    torch_entry.main([str(ours)] + args)
    jax_entry.main([str(ref)] + args)

    names = sorted(p.name for p in (ours / "clipseg_features").iterdir())
    assert names == ["tall.pt", "wide.pt"]
    assert sorted(p.name for p in (ref / "clipseg_features").iterdir()) == names
    for name in names:
        a = torch.load(ours / "clipseg_features" / name, weights_only=False)
        b = torch.load(ref / "clipseg_features" / name, weights_only=False)
        assert set(a) == set(b) == {"activations", "visual_q"} and a["visual_q"] is None
        assert len(a["activations"]) == len(b["activations"]) == 3
        for x, y in zip(a["activations"], b["activations"]):
            assert x.dtype == torch.float32 and x.shape == y.shape == (1025, 1, 64)
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    # the port's training data reads them as the 32x32x192 ClipSeg targets
    files = [ours / "clipseg_features" / n for n in names]
    grids = load_features(files, get_feature=clipseg_pt_to_grid)
    assert grids.shape == (2, 32, 32, 192) and grids.dtype == np.float32
    acts = torch.load(files[0], weights_only=False)["activations"]
    np.testing.assert_array_equal(grids[0, 3, 5], torch.cat(acts, -1)[1 + 3 * 32 + 5, 0].numpy())


def test_new_entry_points_default_to_the_card():
    for fn in (torch_entry.get_embeddings, tpipe.ClipSegPredictor):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
