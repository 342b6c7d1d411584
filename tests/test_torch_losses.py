"""The port's losses (samnerf_tpu_torch.ops.losses) against the JAX
package's (samnerf_tpu.ops.losses), on the CPU: values and gradients with
respect to the weights, rtol 1e-5 / atol 1e-7 (float32 sums in another
order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from samnerf_tpu.core.rays import RaySamples as JaxRaySamples
from samnerf_tpu.ops import losses as jl
from samnerf_tpu_torch.core.rays import RaySamples
from samnerf_tpu_torch.ops import losses as tl

R = 32
TOL = dict(rtol=1e-5, atol=1e-7)


def _levels(seed=0, counts=(12, 8)):
    """Spacing bins (sorted in [0, 1]) and weights for each level."""
    rng = np.random.default_rng(seed)
    out = []
    for s in counts:
        edges = np.sort(rng.uniform(0.0, 1.0, (R, s + 1)), axis=-1).astype(np.float32)
        edges[:, 0], edges[:, -1] = 0.0, 1.0
        w = rng.uniform(0.0, 1.0 / s, (R, s, 1)).astype(np.float32)
        w[:3] = 0.0                                     # empty rays
        out.append((edges, w))
    return out


def _jax_samples(edges):
    z = jnp.zeros((R, 3))
    e = jnp.asarray(edges)[..., None]
    return JaxRaySamples(origins=z, directions=z, starts=e[:, :-1], ends=e[:, 1:],
                         spacing_starts=e[:, :-1], spacing_ends=e[:, 1:],
                         s_near=jnp.zeros((R, 1)), s_far=jnp.ones((R, 1)))


def _torch_samples(edges):
    z = torch.zeros((R, 3))
    e = torch.from_numpy(edges)[..., None]
    return RaySamples(origins=z, directions=z, starts=e[:, :-1], ends=e[:, 1:],
                      spacing_starts=e[:, :-1], spacing_ends=e[:, 1:],
                      s_near=torch.zeros((R, 1)), s_far=torch.ones((R, 1)))


@pytest.mark.parametrize("name", ("interlevel_loss", "distortion_loss"))
def test_sample_losses_match_jax(name):
    levels = _levels()
    ws = [w for _, w in levels]

    def jloss(*wl):
        return getattr(jl, name)(list(wl), [_jax_samples(e) for e, _ in levels])

    ref, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(ws))))(
        *[jnp.asarray(w) for w in ws])
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    out = getattr(tl, name)(tw, [_torch_samples(e) for e, _ in levels])
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    assert float(ref) > 0
    for t, g in zip(tw, jgrads):               # a level the loss does not
        tg = t.grad if t.grad is not None else torch.zeros_like(t)    # reach
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), **TOL)
    assert any(t.grad is not None and t.grad.abs().sum() > 0 for t in tw)


def test_masked_feature_mse_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(40, 24)).astype(np.float32)
    target = rng.normal(size=(40, 24)).astype(np.float32)
    target[[2, 17]] = np.nan                      # pixels without features
    target[5, 3] = np.nan                         # one NaN channel masks its pixel
    ref, jg = jax.value_and_grad(jl.masked_feature_mse)(jnp.asarray(pred),
                                                       jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_()
    out = tl.masked_feature_mse(tp, torch.from_numpy(target))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), **TOL)
    assert not tp.grad[[2, 5, 17]].any()
    all_nan = torch.full((4, 24), float("nan"))
    assert tl.masked_feature_mse(tp[:4], all_nan).item() == 0.0
