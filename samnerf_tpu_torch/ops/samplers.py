"""Ray samplers: stratified spaced sampling, inverse-CDF resampling and the
proposal sampling loop.

Counterpart of ``samnerf_tpu/ops/samplers.py``.  Training draws jitter;
the caller passes it in as uniform [0, 1) tensors (one per sampling
level, [R, 1] for single jitter or [R, S+1]), so a test can hand both
packages the same numbers.  Without jitter sampling is deterministic per
ray (eval and serving).  JAX's ``single_jitter`` is the jitter's shape
here (:func:`jitter_shape`).  The spacing warp defaults to the piecewise
one; the zoo's linear-spacing models pass :func:`spacing_linear` as
``spacing_fn`` and ``spacing_inv``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from samnerf_tpu_torch.core.rays import RayBundle, RaySamples


def spacing_piecewise(x: torch.Tensor) -> torch.Tensor:
    """UniformLinDispPiecewise: first half uniform, second linear in
    disparity."""
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x))


def spacing_piecewise_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x))


def spacing_linear(x: torch.Tensor) -> torch.Tensor:
    """The identity warp: samples evenly spaced in euclidean distance."""
    return x


def spacing_to_euclidean(s, s_near, s_far,
                         spacing_inv: Callable = spacing_piecewise_inv):
    """Undo the spacing warp of normalized bins ``s``."""
    return spacing_inv(s * s_far + (1.0 - s) * s_near)


def jitter_shape(num_rays: int, num_samples: int, single_jitter: bool = True):
    """Shape of one level's uniform jitter: [R, 1] (one offset per ray)
    or [R, S+1] (one per bin edge)."""
    return (num_rays, 1) if single_jitter else (num_rays, num_samples + 1)


def _make_ray_samples(ray_bundle: RayBundle, euclid_bins, spacing_bins,
                      s_near, s_far) -> RaySamples:
    """Bin edges [R, S+1] -> RaySamples [R, S]."""
    return RaySamples(
        origins=ray_bundle.origins, directions=ray_bundle.directions,
        starts=euclid_bins[..., :-1, None], ends=euclid_bins[..., 1:, None],
        spacing_starts=spacing_bins[..., :-1, None],
        spacing_ends=spacing_bins[..., 1:, None], s_near=s_near, s_far=s_far,
        pixel_area=ray_bundle.pixel_area, camera_indices=ray_bundle.camera_indices,
        times=ray_bundle.times)


def initial_samples(ray_bundle: RayBundle, num_samples: int,
                    jitter: Optional[torch.Tensor] = None,
                    spacing_fn: Callable = spacing_piecewise,
                    spacing_inv: Callable = spacing_piecewise_inv) -> RaySamples:
    """Evenly spaced bins in the ``spacing_fn`` warp of [near, far]; with
    ``jitter`` each edge moves uniformly within its half-bins
    (stratified)."""
    num_rays = ray_bundle.origins.shape[0]
    bins = torch.linspace(0.0, 1.0, num_samples + 1,
                          device=ray_bundle.origins.device)[None, :]
    if jitter is not None:
        centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        upper = torch.cat([centers, bins[..., -1:]], dim=-1)
        lower = torch.cat([bins[..., :1], centers], dim=-1)
        bins = lower + (upper - lower) * jitter
    else:
        bins = bins.expand(num_rays, num_samples + 1)
    s_near = spacing_fn(ray_bundle.nears)
    s_far = spacing_fn(ray_bundle.fars)
    return _make_ray_samples(
        ray_bundle, spacing_to_euclidean(bins, s_near, s_far, spacing_inv),
        bins, s_near, s_far)


def searchsorted_right(sorted_seq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Batched insertion indices, side='right': the count of entries of
    ``sorted_seq`` [..., B] that are <= each of ``values`` [..., U]."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(),
                              right=True)


def pdf_samples(ray_bundle: RayBundle, ray_samples: RaySamples,
                weights: torch.Tensor, num_samples: int,
                jitter: Optional[torch.Tensor] = None,
                histogram_padding: float = 0.01, eps: float = 1e-5,
                include_original: bool = False,
                spacing_inv: Callable = spacing_piecewise_inv) -> RaySamples:
    """Inverse-CDF resampling of ``weights`` [R, S_in, 1] at
    ``num_samples + 1`` evenly spaced quantiles, offset by ``jitter`` /
    (S+1) or else by half a quantile step.  ``include_original`` merges
    the input's S_in + 1 edges into the new ones (sorted), giving
    ``num_samples + S_in + 1`` samples.  The new bins carry no gradient
    (the reference's ``stop_gradient``), so neither do the weights
    here."""
    num_bins = num_samples + 1
    w = weights[..., 0].detach() + histogram_padding
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    padding = torch.relu(eps - w_sum)           # zero-weight rays: no NaNs
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    cdf = torch.clamp_max(torch.cumsum(w / w_sum, dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=cdf.device)
    if jitter is not None:
        u = u[None, :] + jitter / num_bins
    else:
        u = (u + 1.0 / (2 * num_bins))[None, :].expand(cdf.shape[0], num_bins)
    existing_bins = torch.cat([ray_samples.spacing_starts[..., 0],
                               ray_samples.spacing_ends[..., -1:, 0]], dim=-1)
    inds = searchsorted_right(cdf, u)
    last = existing_bins.shape[-1] - 1
    below = torch.clamp(inds - 1, 0, last)
    above = torch.clamp(inds, 0, last)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(existing_bins, -1, below)
    bins_g1 = torch.gather(existing_bins, -1, above)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0)), 0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)
    if include_original:
        bins = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1).values
    euclid = spacing_to_euclidean(bins, ray_samples.s_near, ray_samples.s_far,
                                  spacing_inv)
    return _make_ray_samples(ray_bundle, euclid, bins, ray_samples.s_near,
                             ray_samples.s_far)


def proposal_sampling(ray_bundle: RayBundle,
                      density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                      num_proposal_samples: Sequence[int], num_nerf_samples: int,
                      jitter: Optional[Sequence[torch.Tensor]] = None,
                      anneal: Union[float, torch.Tensor] = 1.0,
                      proposal_grad: Union[float, torch.Tensor, None] = None,
                      ) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Proposal-network sampling loop.  Returns (final nerf RaySamples,
    proposal weights, proposal RaySamples); the caller appends the nerf
    level.

    ``jitter``: one uniform tensor per level (proposal levels, then the
    nerf level) for stratified training samples.  ``anneal``: exponent on
    the proposal weights before resampling.  ``proposal_grad``: the
    training gate; density becomes ``d*g + d.detach()*(1-g)``, which has
    value d and gradient g*dd, so at g = 0 the proposal parameters get
    zero gradients (not none: Adam still moves them, as optax does).
    Both are floats, or 0-d tensors in a CUDA graph."""
    weights_list: List[torch.Tensor] = []
    ray_samples_list: List[RaySamples] = []
    jit = list(jitter) if jitter is not None else [None] * (len(density_fns) + 1)
    ray_samples = initial_samples(ray_bundle, num_proposal_samples[0]
                                  if num_proposal_samples else num_nerf_samples,
                                  jit[0])
    for i, density_fn in enumerate(density_fns):
        if i > 0:
            ray_samples = pdf_samples(ray_bundle, ray_samples,
                                      _annealed(weights_list[-1], anneal),
                                      num_proposal_samples[i], jit[i])
        density = density_fn(ray_samples.positions())
        if proposal_grad is not None:
            density = density * proposal_grad + density.detach() * (1.0 - proposal_grad)
        weights_list.append(ray_samples.get_weights(density))
        ray_samples_list.append(ray_samples)
    if density_fns:
        ray_samples = pdf_samples(ray_bundle, ray_samples,
                                  _annealed(weights_list[-1], anneal),
                                  num_nerf_samples, jit[len(density_fns)])
    return ray_samples, weights_list, ray_samples_list


def _annealed(weights: torch.Tensor, anneal) -> torch.Tensor:
    """``weights ** anneal``, the weights themselves at ``anneal`` 1.  A
    0-d tensor ``anneal`` (a CUDA graph's per-step value) selects on the
    device what a float selects on the host: the same values, and no
    gradient either way, since :func:`pdf_samples` detaches its weights."""
    if isinstance(anneal, torch.Tensor):
        return torch.where(anneal == 1.0, weights, torch.pow(weights.detach(), anneal))
    return weights if anneal == 1.0 else torch.pow(weights.detach(), anneal)
