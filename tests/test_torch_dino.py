"""The port's DINO extractor against the JAX package's on the CPU.

A tiny DINO ViT (patch 8, width 32, 2 layers, 2 heads, stride 4) on 40 x 40
images (a 9 x 9 strided grid, so the 28 x 28 position grid shrinks by the
bicubic resize) with numpy-seeded weights in the reference torch layout:
the port loads them as they are, JAX through ``convert_dino_state_dict``.

- f32: every facet of both layers and the final tokens at rtol 1e-5 /
  atol 1e-6, JAX applied without ``jit`` (under ``jit`` the bicubic
  weights move by up to 4e-7, Queue C (a) of the roadmap);
- the chunked-query attention equals the whole one;
- bf16: facets and tokens at ``test_torch_bf16_layers.assert_composite``'s
  tolerance, JAX op by op;
- ``log_bin`` bit for bit (the same numpy sums in the same order);
- the entry point: ``main`` writes the same ``.pt`` per image as JAX's
  ``main`` (which runs under ``jit``: rtol 1e-5 / atol 2e-6) from one
  seeded checkpoint, and the port's loader reads them; binned descriptors
  at atol 1e-5 (a box mean is a difference of running sums over the grid,
  which carries the sums' rounding, not only the box's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from samnerf_tpu.preprocessing import get_dino_embeddings as jdino
from samnerf_tpu_torch.data.feature_loader import load_features
from samnerf_tpu_torch.preprocessing import get_dino_embeddings as tdino

from test_torch_bf16_layers import assert_composite

TINY = dict(patch=8, width=32, layers=2, heads=2)
STRIDE = 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after:
    the suite runs several test processes at once on the same cores,
    where each process's full thread pool oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_state_dict(seed=0, spec=TINY):
    """Reference-layout DINO weights from numpy: every tensor normal, dense
    weights scaled by 1 / sqrt(fan_in), norms about 1."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              tdino.DinoViT(**spec, device="meta").state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        x = rng.normal(size=shape)
        if k.endswith("weight") and len(shape) >= 2:
            x = x / np.sqrt(np.prod(shape[1:]))
        elif k.startswith(("norm", "blocks")) and "norm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif k.endswith("bias"):
            x = 0.1 * x
        else:
            x = 0.2 * x
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def models():
    sd = random_state_dict()
    jparams = {"params": jdino.convert_dino_state_dict(sd, TINY["layers"])}
    ours = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = tdino.DinoViT(**TINY, stride=STRIDE, compute_dtype=dt, device="meta")
        tdino.load_dino_state_dict(m, sd, "cpu")
        ours[name] = m.eval()
    return jparams, ours


def _image(seed=1, shape=(2, 40, 40, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax(jparams, x, dtype=jnp.float32):
    return jdino.DinoViT(**TINY, stride=STRIDE, compute_dtype=dtype).apply(
        jparams, jnp.asarray(x), facet_layers=(0, 1))


def test_facets_and_tokens_match_jax(models):
    jparams, ours = models
    x = _image()
    jtok, jfac, jgrid = _jax(jparams, x)
    with torch.no_grad():
        tok, fac, grid = ours["f32"](torch.from_numpy(x), facet_layers=(0, 1))
    assert grid == tuple(int(g) for g in jgrid) == (9, 9)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), rtol=RTOL, atol=ATOL)
    for layer in (0, 1):
        assert set(fac[layer]) == set(jfac[layer]) == set(tdino.FACETS)
        for name in tdino.FACETS:
            np.testing.assert_allclose(fac[layer][name].numpy(),
                                       np.asarray(jfac[layer][name]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {layer} facet {name}")


def test_rectangular_image_grid_matches_jax(models):
    """A 48 x 40 image: the grid (11, 9) resizes each axis by its own
    matrix."""
    jparams, ours = models
    x = _image(2, (1, 48, 40, 3))
    jtok, _, jgrid = _jax(jparams, x)
    with torch.no_grad():
        tok, _, grid = ours["f32"](torch.from_numpy(x), facet_layers=())
    assert grid == tuple(int(g) for g in jgrid) == (11, 9)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), rtol=RTOL, atol=ATOL)


def test_chunked_queries_equal_whole_attention(models):
    _, ours = models
    x = torch.from_numpy(_image(3))
    facets = ("query", "key", "value", "token")
    with torch.no_grad():
        whole = ours["f32"](x, (0, 1), facets)
        chunked = ours["f32"](x, (0, 1), facets, query_chunk=16)
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(), rtol=1e-6, atol=1e-7)
    for layer in (0, 1):
        for name in facets:
            np.testing.assert_allclose(chunked[1][layer][name].numpy(),
                                       whole[1][layer][name].numpy(), rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        _, with_attn, _ = ours["f32"](x, (1,), ("attn",), query_chunk=16)
    assert with_attn[1]["attn"].shape == (2, 2, 82, 82)


def test_bf16_matches_jax(models):
    jparams, ours = models
    x = _image(4)
    refs = {"bf16": _jax(jparams, x, jnp.bfloat16), "f32": _jax(jparams, x)}
    with torch.no_grad():
        tok, fac, _ = ours["bf16"](torch.from_numpy(x), facet_layers=(0, 1))
    assert tok.dtype == torch.float32 and fac[1]["key"].dtype == torch.bfloat16
    assert_composite(tok, refs["bf16"][0], refs["f32"][0], "DINO tokens")
    for layer in (0, 1):
        for name in ("query", "key", "value", "token"):
            assert_composite(fac[layer][name], refs["bf16"][1][layer][name],
                             refs["f32"][1][layer][name], f"DINO layer {layer} {name}")


@pytest.mark.parametrize("shape,grid", [((1, 2, 81, 16), (9, 9)), ((2, 3, 30, 8), (5, 6))])
def test_log_bin_matches_jax(shape, grid):
    desc = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ours, ref = tdino.log_bin(desc, grid), jdino.log_bin(desc, grid)
    assert ours.shape == ref.shape == (shape[0], 1, shape[2], shape[1] * shape[3] * 17)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("facet,use_bin", [("key", False), ("token", False), ("value", True)])
def test_extract_descriptors_matches_jax(facet, use_bin, tmp_path, monkeypatch):
    """``ViTExtractor.extract_descriptors`` (the JAX one under ``jit``)."""
    for mod in (jdino, tdino):
        monkeypatch.setitem(mod._SPECS, "dino_vits8", TINY)
    ckpt = tmp_path / "dino_vits8.pth"
    torch.save(random_state_dict(6), ckpt)
    jex = jdino.ViTExtractor("dino_vits8", STRIDE, checkpoint=str(ckpt))
    tex = tdino.ViTExtractor("dino_vits8", STRIDE, checkpoint=str(ckpt), query_chunk=32,
                             device="cpu")
    batch = _image(7, (1, 40, 48, 3))
    ref = jex.extract_descriptors(batch, 1, facet, use_bin)
    ours = tex.extract_descriptors(batch, 1, facet, use_bin)
    assert tex.num_patches == jex.num_patches == (9, 11)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    # binned: each box mean is a difference of running sums over the grid,
    # which carries the sums' error (up to 99 inputs' 2e-6), not the box's
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-5 if use_bin else 2e-6)


def _images(root):
    rng = np.random.default_rng(8)
    root.mkdir(parents=True)
    for name, (h, w) in {"a": (40, 48), "b": (48, 40)}.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"{name}.png")
    (root / "notes.txt").write_text("not an image")
    return root


def test_main_writes_jax_files(tmp_path, monkeypatch):
    for mod in (jdino, tdino):
        monkeypatch.setitem(mod._SPECS, "dino_vits8", TINY)
    ckpt = tmp_path / "dino_vits8.pth"
    torch.save(random_state_dict(9), ckpt)
    images = _images(tmp_path / "scene" / "images")
    args = [str(images), "--checkpoint", str(ckpt), "--layer", "1"]
    jdino.main(args + ["--output-path", str(tmp_path / "ref")])
    tdino.main(args + ["--output-path", str(tmp_path / "ours")], device="cpu")
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours").iterdir()) == ["a.pt", "b.pt"]
    for name in names:
        ref = torch.load(tmp_path / "ref" / name)
        ours = torch.load(tmp_path / "ours" / name)
        assert ours.dtype == torch.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=RTOL, atol=2e-6)
    # a scene directory reads its images/; the loader stacks the maps
    tdino.main([str(tmp_path / "scene"), "--checkpoint", str(ckpt), "--layer", "1", "--output-path",
                str(tmp_path / "scene" / "dino_features")], device="cpu")
    feats = load_features([tmp_path / "scene" / "dino_features" / "a.pt"])
    assert feats.shape == (1, 9, 11, TINY["width"]) and feats.dtype == np.float32


def test_seeded_checkpoint_is_reference_layout():
    sd = tdino.seeded_dino_state_dict("dino_vits8", seed=0)
    assert sd["patch_embed.proj.weight"].shape == (384, 3, 8, 8)
    assert sd["pos_embed"].shape == (1, 785, 384)
    assert sd["blocks.11.attn.qkv.weight"].shape == (1152, 384)
    assert sum(v.numel() for v in sd.values()) == 21_670_272
    p = jdino.convert_dino_state_dict(sd, 12)
    assert p["blocks_11"]["fc1"]["kernel"].shape == (384, 1536)
