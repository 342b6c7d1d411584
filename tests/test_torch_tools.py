"""The port's tools against the JAX package, on the CPU.

- The SAM decoder export: ``torch.export`` bytes saved, loaded and run on
  JAX's input contract equal ``Sam.decode_masks`` bit for bit, and JAX's
  ``decode_masks`` on the same weights at atol 1e-4 (the tolerance of
  ``test_torch_predictor.py``'s decoder parity).
- ``DynamicBatchController`` equal to JAX's on a sequence of measurements.
- SDS with the analytic backbone of ``test_export_and_batching.py``: the
  schedule at rtol 2e-6 (torch's and jnp's ``linspace`` differ in the
  last bit, and the product over 1000 steps carries it); ``sds_gradient``
  and ``sds_loss``'s gradient on JAX's timestep and noise draws at rtol
  1e-5 / atol 1e-7; the guided DDIM loop from JAX's start latents at atol
  1e-5; the VAE scaling exact.
- The profiler's table, a ``DeviceTrace`` on the CPU, ``discover_methods``
  empty, ``benchmark.main`` over two scenes with ``train_loop`` patched.
- The native decoder's bytes equal JAX's and PIL's (skipped, as JAX's own
  test skips, without a C++ toolchain), and the DataManager decodes a
  scene's split to JAX's images.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from samnerf_tpu import native as jnative
from samnerf_tpu.engine import dynamic_batch as jdb
from samnerf_tpu.generative import stable_diffusion as jsd
from samnerf_tpu.perception.sam.build_sam import build_sam, convert_torch_state_dict
from samnerf_tpu.perception.sam.sam import Sam as JaxSam
from samnerf_tpu_torch import native as tnative
from samnerf_tpu_torch.engine import dynamic_batch as tdb
from samnerf_tpu_torch.generative import stable_diffusion as tsd
from samnerf_tpu_torch.perception.sam import export as tex
from samnerf_tpu_torch.perception.sam.sam import Sam
from samnerf_tpu_torch.utils import plugins, profiler

from test_torch_convert import decoder_state


@pytest.fixture(scope="module")
def decoder():
    sd = decoder_state(3, for_masks=True)
    sam = Sam(device="cpu")
    sam.load_state_dict(sd)
    return sam, sd


def _prompts(n=4):
    coords = np.zeros((1, n, 2), np.float32)
    coords[0, 0] = [300.0, 520.0]
    coords[0, 1] = [610.0, 200.0]
    labels = np.full((1, n), -1, np.int32)
    labels[0, :2] = [1, 0]
    emb = np.random.default_rng(4).normal(size=(1, 64, 64, 256)).astype(np.float32)
    return emb, coords, labels


@pytest.mark.parametrize("multimask", [False, True])
def test_decoder_export_round_trip(decoder, tmp_path, multimask):
    sam, sd = decoder
    exp = tex.export_decoder(sam, num_points=4, multimask_output=multimask)
    assert exp.num_points == 4 and exp.multimask_output == multimask
    tex.save_decoder(tmp_path / "decoder.pt2", exp)
    emb, coords, labels = _prompts()
    args = (torch.from_numpy(emb), torch.from_numpy(coords), torch.from_numpy(labels))
    low, iou = tex.load_and_run(tmp_path / "decoder.pt2", *args)
    low_b, iou_b = tex.load_and_run(exp.artifact, *args)
    ref_low, ref_iou = sam.decode_masks(args[0], (args[1], args[2]),
                                        multimask_output=multimask)
    k = 3 if multimask else 1
    assert low.shape == (1, k, 256, 256) and iou.shape == (1, k)
    for a, b in ((low, ref_low), (iou, ref_iou), (low_b, ref_low), (iou_b, ref_iou)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())

    jsam, _ = build_sam("vit_b")
    jparams = {"params": convert_torch_state_dict(sd, depth=12)}
    jlow, jiou = jsam.apply(jparams, jnp.asarray(emb),
                            (jnp.asarray(coords), jnp.asarray(labels)), None, None,
                            multimask, method=JaxSam.decode_masks)
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), atol=1e-4, rtol=0)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-4, rtol=0)
    # another click through the same artifact: the labels are inputs
    labels2 = labels.copy()
    labels2[0, 1] = 1
    low2, _ = tex.load_and_run(exp.artifact, args[0], args[1], torch.from_numpy(labels2))
    assert not torch.equal(low2, low)


def test_dynamic_batch_matches_jax():
    seq = [(1 << 12) * 32, 2048.0, 0.0, -5.0, 1e9, 3e6, 1.0, 5e5]
    for cfg_kw, init in [({}, 1 << 14), ({"target_num_samples": 1 << 16}, 1 << 12),
                         ({"max_num_rays_per_batch": 1 << 13}, 5000)]:
        jc = jdb.DynamicBatchController(jdb.DynamicBatchConfig(**cfg_kw), init)
        tc = tdb.DynamicBatchController(tdb.DynamicBatchConfig(**cfg_kw), init)
        assert tc.rays_per_batch == jc.rays_per_batch
        for m in seq:
            assert tc.update(m) == jc.update(m)


X0 = 0.7


def _pair(**kw):
    """Both packages' guidance over JAX's analytic backbone: a perfect
    denoiser for a delta at X0, whose DDIM loop recovers X0."""
    j = jsd.StableDiffusionGuidance(
        unet_fn=lambda z, t, e: (z - jnp.sqrt(j.alphas_cumprod[t]) * X0)
        / jnp.sqrt(1.0 - j.alphas_cumprod[t]),
        vae_encode_fn=lambda img: img[..., :4] * 2.0, vae_decode_fn=lambda lat: lat / 2.0,
        text_embed_fn=lambda prompts: jnp.zeros((len(prompts), 2, 8)), **kw)
    t = tsd.StableDiffusionGuidance(
        unet_fn=lambda z, ts, e: (z - torch.sqrt(t.alphas_cumprod[ts]) * X0)
        / torch.sqrt(1.0 - t.alphas_cumprod[ts]),
        vae_encode_fn=lambda img: img[..., :4] * 2.0, vae_decode_fn=lambda lat: lat / 2.0,
        text_embed_fn=lambda prompts: torch.zeros((len(prompts), 2, 8)), device="cpu", **kw)
    return j, t


def _jax_draws(rng, shape, num_steps, t_range=(0.02, 0.98)):
    """JAX's sds_gradient draws from ``rng`` (the split it makes)."""
    k_t, k_n = jax.random.split(rng)
    t = jax.random.randint(k_t, (), int(t_range[0] * num_steps), int(t_range[1] * num_steps))
    return int(t), np.asarray(jax.random.normal(k_n, shape))


def test_schedule_matches_jax():
    np.testing.assert_allclose(tsd.scaled_linear_alphas_cumprod(device="cpu").numpy(),
                               np.asarray(jsd.scaled_linear_alphas_cumprod()), rtol=2e-6)
    assert tsd.CONST_SCALE == jsd.CONST_SCALE


def test_sds_gradient_and_loss_match_jax():
    def jden(noisy, t, emb):
        return noisy * 0.5 + jnp.tanh(noisy) * 0.1

    def tden(noisy, t, emb):
        return noisy * 0.5 + torch.tanh(noisy) * 0.1

    lat = np.random.default_rng(5).normal(size=(1, 8, 8, 4)).astype(np.float32)
    emb = np.zeros((1, 16), np.float32)
    ac = np.linspace(0.999, 0.01, 100).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    t, noise = _jax_draws(rng, lat.shape, 100)
    ref = jsd.sds_gradient(jden, jnp.asarray(lat), jnp.asarray(emb), rng, jnp.asarray(ac))
    got = tsd.sds_gradient(tden, torch.from_numpy(lat), torch.from_numpy(emb), None,
                           torch.from_numpy(ac), t=torch.tensor(t),
                           noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    jgrad = jax.grad(lambda x: jsd.sds_loss(jden, x, jnp.asarray(emb), rng,
                                            jnp.asarray(ac)))(jnp.asarray(lat))
    x = torch.from_numpy(lat).requires_grad_()
    tsd.sds_loss(tden, x, torch.from_numpy(emb), None, torch.from_numpy(ac),
                 t=torch.tensor(t), noise=torch.from_numpy(noise)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    # its own draws: a timestep in range and unit-variance noise
    g = torch.Generator().manual_seed(0)
    own = tsd.sds_gradient(tden, torch.from_numpy(lat), torch.from_numpy(emb), g,
                           torch.from_numpy(ac))
    assert own.shape == lat.shape and torch.isfinite(own).all()


def test_guidance_pipeline_matches_jax():
    jsd_, tsd_ = _pair(guidance_scale=7.5)
    jemb = jsd_.get_text_embeds("a photo of a chair")
    temb = tsd_.get_text_embeds("a photo of a chair")
    assert tuple(temb.shape) == jemb.shape == (2, 2, 8)
    rng = jax.random.PRNGKey(0)
    start = np.asarray(jax.random.normal(rng, (1, 4, 4, 4)))
    jlat = jsd_.produce_latents(jemb, height=32, width=32, num_inference_steps=25, rng=rng)
    tlat = tsd_.produce_latents(temb, height=32, width=32, num_inference_steps=25,
                                latents=torch.from_numpy(start))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlat.numpy(), X0, atol=1e-3)
    img = np.full((1, 4, 4, 4), 0.5, np.float32)
    assert float(tsd_.imgs_to_latent(torch.from_numpy(img))[0, 0, 0, 0]) == float(
        jsd_.imgs_to_latent(jnp.asarray(img))[0, 0, 0, 0])
    np.testing.assert_array_equal(tsd_.latents_to_img(torch.from_numpy(img)).numpy(),
                                  np.asarray(jsd_.latents_to_img(jnp.asarray(img))))
    # SDS through the guided pipeline on JAX's draws
    images = np.full((1, 4, 4, 4), 0.2, np.float32)
    t, noise = _jax_draws(jax.random.PRNGKey(1), (1, 4, 4, 4), 1000,
                          (jsd_.min_step / 1000, jsd_.max_step / 1000))
    jg = jax.grad(lambda im: jsd_.sds(jemb, im, jax.random.PRNGKey(1)))(jnp.asarray(images))
    x = torch.from_numpy(images).requires_grad_()
    tsd_.sds(temb, x, t=torch.tensor(t), noise=torch.from_numpy(noise)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    assert float(x.grad.abs().max()) > 0
    with pytest.raises(ImportError):
        tsd.StableDiffusionGuidance(device="cpu").get_text_embeds("x")
    with pytest.raises(ImportError):
        tsd.load_stable_diffusion()


def test_profiler_table_and_trace(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(profiler, "_STATS", {})
    monkeypatch.setattr(profiler, "PROFILER_ENABLED", False)

    @profiler.time_function
    def work(n):
        return sum(range(n))

    assert work(10) == 45
    profiler.flush_profiler()
    assert capsys.readouterr().out == ""               # nothing timed while off
    profiler.enable_profiler()
    for n in (10, 20, 30):
        work(n)
    profiler.flush_profiler()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Profiler (mean seconds per call):"
    assert "test_profiler_table_and_trace.<locals>.work" in out[1] and out[1].endswith("x3")
    with profiler.DeviceTrace(tmp_path / "trace") as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(trace.path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_discover_methods_empty():
    assert plugins.discover_methods() == {}
    assert plugins.ENTRY_POINT_GROUP == "samnerf_tpu_torch.method_configs"


def test_benchmark_driver_fresh_config_per_scene(tmp_path, monkeypatch):
    """A fresh preset per scene (``apply_overrides`` changes a config in
    place, so reusing one would compound output_dir), json events, and the
    summary of ``compute_eval_metrics``."""
    from samnerf_tpu_torch.scripts import benchmark as bm

    seen = []

    def fake_train_loop(config, device="cuda", step_callback=None, num_devices=None):
        seen.append((str(config.trainer.output_dir), config.vis,
                     str(config.datamanager.dataparser.data), device))
        return object()

    monkeypatch.setattr("samnerf_tpu_torch.train.train_loop", fake_train_loop)
    monkeypatch.setattr("samnerf_tpu_torch.train.save_config", lambda c: None)
    monkeypatch.setattr("samnerf_tpu_torch.utils.eval_utils.compute_eval_metrics",
                        lambda t, max_images=None: {"psnr": 30.0, "ssim": 0.9,
                                                    "num_images": 1})
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    out = tmp_path / "bench.json"
    argv = ["samnerf_distill", "--scenes", f"{tmp_path}/a,{tmp_path}/b", "--output", str(out),
            "--trainer.output-dir", str(tmp_path / "runs")]
    assert bm.main(list(argv), device="cpu") == 0
    assert seen == [(str(tmp_path / "runs" / s / "samnerf_distill"), "json",
                     str(tmp_path / s), "cpu") for s in ("a", "b")]
    summary = json.loads(out.read_text())
    assert summary["mean_psnr"] == 30.0 and set(summary["scenes"]) == {"a", "b"}
    assert bm.main(["nope", "--scenes", "x"], device="cpu") == 2
    assert bm.main(["samnerf_distill"], device="cpu") == 2


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i in range(5):
        img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        suffix = "jpg" if i % 2 else "png"
        Image.fromarray(img).save(d / f"im{i}.{suffix}")
        paths.append(d / f"im{i}.{suffix}")
        arrays.append(img)
    rgba = rng.integers(0, 255, (32, 48, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(d / "alpha.png")
    paths.append(d / "alpha.png")
    return paths, np.stack(arrays)


def test_native_decoder_matches_jax(images):
    if tnative.get_loader() is None or jnative.get_loader() is None:
        pytest.skip("native toolchain unavailable")
    paths, ref = images
    out = tnative.decode_images(paths, 32, 48)
    np.testing.assert_array_equal(out, jnative.decode_images(paths, 32, 48))
    pngs = [0, 2, 4]
    np.testing.assert_array_equal(out[pngs], ref[pngs])
    np.testing.assert_array_equal(tnative.decode_images(paths[:2], 16, 24, downscale=2),
                                  jnative.decode_images(paths[:2], 16, 24, downscale=2))
    assert tnative.decode_images(paths, 16, 16) is None          # sizes differ
    assert tnative.get_loader()._name.startswith(str(tnative.BUILD_DIR))


def test_datamanager_images_match_jax(tmp_path):
    from samnerf_tpu.data.datamanager import DataManager as JaxDataManager
    from samnerf_tpu.data.datamanager import DataManagerConfig as JaxDMConfig
    from samnerf_tpu.data.dataparser import DataparserConfig as JaxDPConfig
    from samnerf_tpu_torch.data.datamanager import DataManager, DataManagerConfig
    from samnerf_tpu_torch.data.dataparser import DataparserConfig
    from samnerf_tpu_torch.utils import synthetic

    scene = synthetic.write_scene(tmp_path / "scene", num_train=3, num_test=1, h=24, w=32)
    mine = DataManager(DataManagerConfig(dataparser=DataparserConfig(
        data=scene, train_val_json_split=True)))
    ref = JaxDataManager(JaxDMConfig(dataparser=JaxDPConfig(data=scene,
                                                            train_val_json_split=True)))
    np.testing.assert_array_equal(mine.images, ref.images)
    np.testing.assert_array_equal(mine.eval_images, ref.eval_images)
