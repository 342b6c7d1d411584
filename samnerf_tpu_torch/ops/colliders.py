"""Scene colliders, counterpart of ``samnerf_tpu/ops/colliders.py``
(``near_far_collider``; the AABB and sphere colliders wait)."""
from __future__ import annotations

from samnerf_tpu_torch.core.rays import RayBundle


def near_far_collider(ray_bundle: RayBundle, near: float, far: float) -> RayBundle:
    """Constant near/far for every ray."""
    return ray_bundle.with_near_far(near, far)
