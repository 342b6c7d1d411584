"""The port's image metrics (``samnerf_tpu_torch/utils/metrics.py``)
against the JAX package's on the CPU, on seeded inputs.

Tolerances: psnr and ssim rtol 1e-5 (f32 sums in another order); ssim of
an image with itself is 1, of two constant images the closed form.  The
constants are 0 or powers of two, so E[x^2] - E[x]^2 cancels exactly in
f32 in both packages; at other constants that difference is rounding
noise (~1e-6 against c2 = 9e-4) which XLA and torch sum in other orders,
3e-4 apart at 0.25 / 0.75.  LPIPS
rtol 1e-4: thirteen f32 3x3 convolutions summed in another order, on
seeded VGG16 ``features.*`` weights (He-normal, about 14.7 M parameters;
the classifier is not needed) and non-negative lin heads, saved as the
torchvision and lpips state dicts and loaded by both packages from the
same files.  One odd size (37x45) checks that both poolings floor.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from samnerf_tpu.utils import metrics as jm
from samnerf_tpu_torch.utils import metrics as tm

VGG_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def lpips_state_dicts(seed=0, lin_prefix="lin"):
    """Seeded torchvision VGG16 ``features.*`` and lpips head state dicts."""
    rng = np.random.default_rng(seed)
    widths = [c for c in jm._VGG_CFG if c != "M"]
    vgg, ch = {}, 3
    for idx, c in zip(VGG_CONVS, widths):
        w = rng.normal(0.0, np.sqrt(2.0 / (ch * 9)), (c, ch, 3, 3))
        vgg[f"features.{idx}.weight"] = torch.from_numpy(w.astype(np.float32))
        vgg[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0.0, 0.01, c).astype(np.float32))
        ch = c
    lin = {}
    for i, ci in enumerate(jm._TAPS):
        c = widths[ci]
        key = f"lin{i}.model.1.weight" if lin_prefix == "lin" else f"lins.{i}.model.1.weight"
        lin[key] = torch.from_numpy(np.abs(rng.normal(0.0, 0.1, (1, c, 1, 1)))
                                    .astype(np.float32))
    return vgg, lin


def write_lpips_weights(root, seed=0, lin_prefix="lin"):
    """The two files, as ``load_lpips_params`` finds them."""
    vgg, lin = lpips_state_dicts(seed, lin_prefix)
    paths = (root / "vgg16-397923af.pth", root / "lpips_vgg.pth")
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return tuple(str(p) for p in paths)


def _pair(seed, h=24, w=20):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, a.shape), 0.0, 1.0).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psnr_and_ssim_match_jax(seed):
    a, b = _pair(seed)
    np.testing.assert_allclose(tm.psnr(torch.from_numpy(a), torch.from_numpy(b)).item(),
                               float(jm.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(tm.ssim(torch.from_numpy(a), torch.from_numpy(b)).item(),
                               float(jm.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_ssim_of_identical_and_constant_images():
    a, _ = _pair(3)
    t = torch.from_numpy(a)
    np.testing.assert_allclose(tm.ssim(t, t).item(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tm.ssim(t, t).item(), float(jm.ssim(jnp.asarray(a),
                                                                   jnp.asarray(a))), rtol=1e-5)
    for x, y in ((0.25, 0.5), (0.5, 0.5), (0.0, 1.0), (0.125, 0.5)):
        p, q = np.full((16, 16, 3), x, np.float32), np.full((16, 16, 3), y, np.float32)
        ours = tm.ssim(torch.from_numpy(p), torch.from_numpy(q)).item()
        c1 = 0.01 ** 2
        closed = (2 * x * y + c1) / (x * x + y * y + c1)     # variances are 0
        np.testing.assert_allclose(ours, closed, rtol=1e-5)
        np.testing.assert_allclose(ours, float(jm.ssim(jnp.asarray(p), jnp.asarray(q))),
                                   rtol=1e-5)
        assert tm.psnr(torch.from_numpy(p), torch.from_numpy(q)).item() == pytest.approx(
            float(jm.psnr(jnp.asarray(p), jnp.asarray(q))), rel=1e-5)


def test_ssim_stays_in_range_at_any_scale():
    """The variance clamp and the covariance clip keep each score in
    [-1, 1] where E[x^2] - E[x]^2 rounds below 0."""
    rng = np.random.default_rng(4)
    a = (1e3 + rng.uniform(size=(20, 20, 3)) * 1e-3).astype(np.float32)
    b = (1e3 - rng.uniform(size=(20, 20, 3)) * 1e-3).astype(np.float32)
    assert -1.0 <= tm.ssim(torch.from_numpy(a), torch.from_numpy(b)).item() <= 1.0
    assert -1.0 <= float(jm.ssim(jnp.asarray(a), jnp.asarray(b))) <= 1.0


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    return write_lpips_weights(tmp_path_factory.mktemp("lpips"))


@pytest.mark.parametrize("hw", [(32, 32), (37, 45)])
def test_lpips_matches_jax(lpips_files, hw):
    vgg_path, lin_path = lpips_files
    ours = tm.load_lpips_params(vgg_path, lin_path, device="cpu")
    ref = jm.load_lpips_params(vgg_path, lin_path)
    a, b = _pair(5, *hw)
    got = tm.lpips(torch.from_numpy(a), torch.from_numpy(b), ours).item()
    want = float(jm.lpips(jnp.asarray(a), jnp.asarray(b), ref))
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tm.lpips(torch.from_numpy(a), torch.from_numpy(a), ours).item() == 0.0


def test_lpips_weights_load_by_env_and_either_head_prefix(tmp_path, monkeypatch):
    paths = write_lpips_weights(tmp_path, seed=1, lin_prefix="lins")
    monkeypatch.setenv("LPIPS_VGG_WEIGHTS", paths[0])
    monkeypatch.setenv("LPIPS_LIN_WEIGHTS", paths[1])
    model = tm.load_lpips_params(device="cpu")
    vgg, lin = lpips_state_dicts(1, "lins")
    state = model.state_dict()
    assert set(state) == {k for k in vgg} | {f"lins.{i}.weight" for i in range(5)}
    for k, v in vgg.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    torch.testing.assert_close(state["lins.4.weight"], lin["lins.4.model.1.weight"],
                               rtol=0, atol=0)
    a, b = _pair(6, 32, 32)
    np.testing.assert_allclose(
        tm.lpips(torch.from_numpy(a), torch.from_numpy(b), model).item(),
        float(jm.lpips(jnp.asarray(a), jnp.asarray(b), jm.load_lpips_params())), rtol=1e-4)


def test_load_lpips_params_returns_none_without_files(tmp_path, monkeypatch):
    monkeypatch.setenv("LPIPS_VGG_WEIGHTS", str(tmp_path / "absent_vgg.pth"))
    monkeypatch.setenv("LPIPS_LIN_WEIGHTS", str(tmp_path / "absent_lin.pth"))
    assert tm.load_lpips_params(device="cpu") is None
    assert jm.load_lpips_params() is None
    vgg_path, _ = write_lpips_weights(tmp_path)
    assert tm.load_lpips_params(vgg_path, str(tmp_path / "absent_lin.pth")) is None
