"""The port's quality scripts (``samnerf_tpu_torch/scripts/quality_*.py``
and ``validate_zoo.py``) against the JAX package's ``scripts/`` on the
CPU, whose files are imported by path:

- ``miou`` and ``trivial_psnr``: the same numpy, equal to 1e-12;
- ``grid_mIoU`` at grid 4 through the port's and JAX's ``SamPredictor``
  after ``set_feature`` on one seeded 64x64x256 map, with the decoder's
  weights carried across by ``convert_torch_state_dict``: at most
  ``MASK_FLIP_SHARE`` of the mask pixels may differ (logits a few 1e-6
  apart after f32 sums in another order flip pixels within that of 0);
- the target writer ``make_vit_features`` with a narrow encoder at SAM's
  real 1024 input (64x64 embeddings) against JAX's ``encode_image`` with
  the same weights, within ``chip_smoke.TOL_ENCODE``;
- a tiny ``train_and_eval`` (the ``samnerf_distill`` preset at 2^12 /
  2^10 tables, 2 steps of 256 rays, 2 views of 32x32) and one
  ``view_miou``: every metric finite, both doc sections written.  Cut to
  size for the CPU: renders in 1024-ray chunks (a 32x32 image; the
  renderer's default pads to 32768), a 16x16 SAM grid in place of 64x64
  (``get_feature_size``'s ``largesize``), and a narrow encoder at a 256
  input whose 16x16 embedding meets that grid in the prompt encoder.
"""
import functools
import importlib.util
import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from samnerf_tpu.perception.sam import image_encoder as jie
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu.perception.sam.mask_decoder import MaskDecoder as JaxMaskDecoder
from samnerf_tpu.perception.sam.predictor import SamPredictor as JaxPredictor
from samnerf_tpu.perception.sam.prompt_encoder import PromptEncoder as JaxPromptEncoder
from samnerf_tpu.perception.sam.sam import Sam as JaxSam
from samnerf_tpu.perception.sam.transforms import ResizeLongestSide as JaxResize
from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam
from samnerf_tpu_torch.scripts import quality_capacity as tqc
from samnerf_tpu_torch.scripts import quality_distill_miou as tqm
from samnerf_tpu_torch.scripts import validate_zoo as tvz
from samnerf_tpu_torch.utils.init import init_state
from samnerf_tpu_torch.utils.synthetic import write_textured_scene

import chip_smoke
from test_torch_convert import decoder_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MASK_FLIP_SHARE = 1e-3
# a narrow ViT at SAM's 1024 input: 64x64 tokens, so set_image and a
# rendered 64x64 grid reach the same prompt encoder
NARROW = dict(img_size=1024, patch_size=16, embed_dim=32, depth=2, num_heads=2,
              mlp_ratio=2.0, out_chans=256, use_rel_pos=True, window_size=14,
              global_attn_indexes=(1,))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_miou():
    return _jax_script("quality_distill_miou")


def _narrow_state(spec=NARROW, seed=1):
    enc = ImageEncoderViT(**spec, device="meta")
    state = {f"image_encoder.{k}": v for k, v in
             init_state(enc, torch.Generator().manual_seed(seed), "cpu").items()}
    return {**state, **decoder_state(seed, for_masks=True)}


@pytest.fixture(scope="module")
def narrow():
    """(port Sam, JAX Sam, JAX params) of the narrow encoder and SAM's
    decoder, one reference-layout state dict."""
    state = _narrow_state()
    sam = Sam(image_encoder=ImageEncoderViT(**NARROW, device="cpu"), device="cpu")
    sam.load_state_dict(state)
    jsam = JaxSam(
        image_encoder=jie.ImageEncoderViT(**NARROW),
        prompt_encoder=JaxPromptEncoder(embed_dim=256, image_embedding_size=(64, 64),
                                        input_image_size=(1024, 1024), mask_in_chans=16),
        mask_decoder=JaxMaskDecoder(transformer_dim=256, num_multimask_outputs=3,
                                    iou_head_depth=3, iou_head_hidden_dim=256))
    params = {"params": convert_torch_state_dict(state, depth=NARROW["depth"])}
    return sam.eval(), jsam, params


def test_miou_matches_jax(jax_miou):
    rng = np.random.default_rng(0)
    a = rng.random((9, 12, 10)) > 0.6
    b = rng.random((9, 12, 10)) > 0.5
    a[3], b[3] = False, False              # empty against empty counts 1
    a[4], b[4] = True, False               # nothing shared counts 0
    for x, y in ((a, b), (a, a), (b, a)):
        assert abs(tqm.miou(x, y) - jax_miou.miou(x, y)) <= 1e-12
    assert tqm.miou(a, a) == 1.0 and tqm.miou(a[3:5], b[3:5]) == 0.5


@pytest.mark.parametrize("detail", [1.0, 2.0])
def test_trivial_psnr_matches_jax(tmp_path, detail):
    jax_zoo = _jax_script("validate_zoo")
    scene = write_textured_scene(tmp_path / "scene", num_train=2, num_test=2, h=24, w=32,
                                 detail=detail)
    ours = tvz.trivial_psnr(scene)
    assert 5.0 < ours < 30.0
    assert abs(ours - jax_zoo.trivial_psnr(scene)) <= 1e-12


def test_zoo_log_parsing_and_doc(tmp_path, monkeypatch):
    """``run_method`` reads the train entry's last PSNR line and the doc
    gives each method's margin; the process is faked (it needs a card)."""
    def fake_run(cmd, stdout, **kw):
        stdout.write("step 200: loss=0.01\neval view 0 PSNR: 19.25; saved x\n"
                     if cmd[3] == "instant-ngp" else "Traceback: boom\n")
        return type("R", (), {"returncode": 0 if cmd[3] == "instant-ngp" else 1})()

    monkeypatch.setattr(tvz.subprocess, "run", fake_run)
    p, _, _ = tvz.run_method("instant-ngp", tmp_path, 200, 4096, tmp_path / "work")
    assert p == 19.25
    q, _, tail = tvz.run_method("tensorf", tmp_path, 10, 4096, tmp_path / "work")
    assert q is None and tail == ["Traceback: boom"]
    out = tmp_path / "ZOO_torch.md"
    args = tvz.parse_args(["--out", str(out)])
    tvz.write_doc(out, [("instant-ngp", 200, p, 12.0), ("tensorf", 10, None, 3.0)], args,
                  12.5, "NVIDIA H100 80GB HBM3, 700.00 W")
    text = out.read_text()
    assert "| instant-ngp | 200 | 19.25 | +6.8 dB | 12s |" in text
    assert "| tensorf | 10 | FAILED |" in text and "700.00 W" in text


@pytest.mark.parametrize("argv,seed", [([], 42), (["--seed", "3"], 3)])
def test_zoo_runner_passes_the_seed(tmp_path, monkeypatch, argv, seed):
    """``--seed`` reaches the train entry of every method and the doc
    names it (42, the entry's default, unless given)."""
    cmds = []

    def fake_run(cmd, stdout, **kw):
        cmds.append(cmd)
        stdout.write("eval view 0 PSNR: 19.25; saved x\n")
        return type("R", (), {"returncode": 0})()

    monkeypatch.setattr(tvz.subprocess, "run", fake_run)
    args = tvz.parse_args(argv + ["--out", str(tmp_path / "ZOO_torch.md")])
    tvz.run_method("depth-nerfacto", tmp_path, 10, 4096, tmp_path / "work", args.seed)
    assert cmds[0][cmds[0].index("--seed") + 1] == str(seed)
    tvz.write_doc(tmp_path / "ZOO_torch.md", [("depth-nerfacto", 10, 19.25, 1.0)], args,
                  12.5, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert f"seed {seed}," in (tmp_path / "ZOO_torch.md").read_text()


def test_grid_miou_matches_jax(jax_miou):
    dec = decoder_state(3, for_masks=True)
    sam = Sam(device="cpu")
    sam.load_state_dict(dec)
    jsam, _ = build_sam("vit_b")
    jpred = JaxPredictor(jsam, {"params": convert_torch_state_dict(dec, depth=12)})
    pred = SamPredictor(sam)
    feat = np.random.default_rng(11).normal(size=(64, 64, 256)).astype(np.float32)
    size = (80, 80)
    pred.set_feature(feat, size)
    jpred.set_feature(jnp.asarray(feat), size)
    ours = tqm.grid_mIoU(pred, 4, chunk=6)
    ref = np.asarray(jax_miou.grid_mIoU(jpred, 4, chunk=6))
    assert ours.shape == ref.shape == (16, 80, 80) and ours.dtype == bool
    assert 0.02 < ours.mean() < 0.98        # masks with boundaries in the frame
    flips = float((ours != ref).mean())
    assert flips <= MASK_FLIP_SHARE, flips
    assert tqm.miou(ours, ref) >= 0.99


def test_target_writer_matches_jax_encoder(tmp_path, narrow):
    sam, jsam, params = narrow
    scene = write_textured_scene(tmp_path / "scene", num_train=1, num_test=1, h=32, w=32,
                                 with_features=True, detail=3.0)
    got, times = tqm.make_vit_features(scene, sam=sam, device="cpu")
    assert got is sam and len(times) == 2
    tf = JaxResize(1024)
    from PIL import Image
    for p in sorted((scene / "images").glob("*.png")):
        x = jsam.preprocess(jnp.asarray(tf.apply_image(np.asarray(Image.open(p))),
                                        jnp.float32)[None])
        ref = np.moveaxis(np.asarray(jsam.apply(params, x, method=jsam.encode_image))[0], -1, 0)
        ours = np.load(scene / "sam_features" / f"{p.stem}.npy")
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (256, 64, 64)
        err = float(np.abs(ours - ref).max())
        assert err <= chip_smoke.TOL_ENCODE, err


def test_tiny_train_and_eval_and_view_miou(tmp_path, monkeypatch):
    from samnerf_tpu_torch.engine import eval_render

    spec = dict(NARROW, img_size=256)
    sam = Sam(image_encoder=ImageEncoderViT(**spec, device="cpu"), device="cpu")
    sam.load_state_dict(_narrow_state(spec))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(eval_render.ImageRenderer.__init__, "__defaults__", (1024,))
    monkeypatch.setattr(eval_render, "get_feature_size",
                        functools.partial(eval_render.get_feature_size, largesize=16))
    scene = write_textured_scene(tmp_path / "scene", num_train=2, num_test=1, h=32, w=32,
                                 with_features=True, detail=2.0)
    m, trainer = tqc.train_and_eval(scene, 12, 10, 2, 256, args_views=2, hash_fn="morton",
                                    return_trainer=True, persist_run=True, device="cpu")
    run = tmp_path / "qruns" / "12-morton-2"
    assert (run / "config.json").exists() and list((run / "samnerf_tpu_torch_ckpts").glob("*.pt"))
    for k in ("psnr", "ssim", "train_psnr", "sam_feature_mse", "sam_feature_cos",
              "train_s", "rays_per_s", "step_ms"):
        assert math.isfinite(m[k]), (k, m[k])
    assert m["num_images"] == 1 and m["resumed_from"] == 0

    cams = trainer.datamanager.eval_cameras
    gt = scene / "images" / "frame_00002.png"
    v, v_gt = tqm.view_miou(eval_render.ImageRenderer(trainer.model), cams, 0, sam, 4, gt_path=gt,
                            save_dir=tmp_path, tag="test")
    assert 0.0 <= v <= 1.0 and 0.0 <= v_gt <= 1.0
    assert (tmp_path / "test_0_render.png").exists()

    out = tmp_path / "docs" / "QUALITY_torch.md"
    cap = tqc.parse_args(["--steps", "2", "--res", "32", "--views", "2", "--out", str(out)])
    mi = tqm.parse_args(["--steps", "2", "--res", "32", "--views", "2", "--grid", "2",
                         "--out", str(out)])
    tqc.write_doc(out, [(12, 10, m)], cap, "CPU")
    tqm.write_section(out, mi, m, [(v, v_gt, 1.0)], [(v, v_gt, 1.0)], "CPU", [5.0, 6.0],
                      redrawn=[(1, [(0.25, 0.5, 2.0), (0.75, 0.5, 3.0)])])
    tqc.write_doc(out, [(12, 10, m)], cap, "CPU")      # the mIoU section stays
    text = out.read_text()
    assert text.count("# Quality vs hash-table capacity") == 1
    assert text.count(tqm.SECTION) == 1 and "| held-out 0 |" in text and "on CPU" in text
    assert "| mean (held-out), decoder redrawn from seed 1 | 0.5000 | 0.5000 | 5.0 |" in text


@pytest.mark.parametrize("name", ["depth-nerfacto", "semantic-nerfw"])
def test_zoo_trains_on_the_validation_scene(tmp_path, monkeypatch, name):
    """``validate_zoo``'s scene has no depths and no semantics: the methods
    that read them train all the same, as JAX's ``train_zoo`` does (its
    gradient of the unreached semantic head is zero, and Adam leaves the
    head where it was)."""
    from samnerf_tpu_torch import train as ttrain
    from samnerf_tpu_torch.configs.zoo import init_zoo_params, zoo_methods
    from test_torch_zoo_train import tiny_configs

    tiny_configs(monkeypatch)
    scene = write_textured_scene(tmp_path / "scene", num_train=3, num_test=2, h=24, w=24,
                                 detail=2.0)
    runs, losses = [], []
    rc = ttrain.main([name, "--data", str(scene), "--max-num-iterations", "2",
                      "--rays-per-batch", "64", "--output-dir", str(tmp_path / "out")],
                     device="cpu", step_callback=lambda s, m: losses.append(m),
                     run_callback=runs.append)
    assert rc == 0 and math.isfinite(runs[0].psnr) and len(losses) == 1      # one chunk
    assert all(math.isfinite(float(v)) for m in losses for v in m.values())
    if name == "semantic-nerfw":
        model, _ = zoo_methods()[name].build(device="cpu")
        init = init_zoo_params(model, torch.Generator().manual_seed(42), "cpu")  # --seed
        head = {k: v for k, v in runs[0].model.state_dict().items()
                if k.startswith("semantic_head.")}
        assert head and all(torch.equal(v, init[k]) for k, v in head.items())
        trained = runs[0].model.state_dict()
        assert any(not torch.equal(trained[k], v) for k, v in init.items()
                   if k.startswith("backbone."))          # the backbone did train
