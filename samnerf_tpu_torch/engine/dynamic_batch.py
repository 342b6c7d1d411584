"""Rays-per-batch control in the manner of instant-ngp.

Counterpart of ``samnerf_tpu/engine/dynamic_batch.py``: the controller
scales the rays per batch so that rays x measured samples per ray stays
near a sample budget, in power-of-two buckets between a floor and a cap.
Neither package's trainer attaches it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DynamicBatchConfig:
    target_num_samples: int = 1 << 22
    max_num_rays_per_batch: int = 1 << 16
    min_num_rays_per_batch: int = 1 << 10


class DynamicBatchController:
    """Tracks measured samples per ray and gives a bucketed rays per batch."""

    def __init__(self, config: DynamicBatchConfig, initial_rays_per_batch: int = 1 << 14):
        self.config = config
        self.rays_per_batch = self._bucket(initial_rays_per_batch)

    def _bucket(self, n: int) -> int:
        """The largest power of two times the floor that is at most
        min(n, cap), and the floor itself below it."""
        b = self.config.min_num_rays_per_batch
        while b * 2 <= min(n, self.config.max_num_rays_per_batch):
            b *= 2
        return b

    def update(self, measured_num_samples: float) -> int:
        """Feed the samples the last batch used; returns the next rays per
        batch (unchanged for a non-positive measurement)."""
        if measured_num_samples <= 0:
            return self.rays_per_batch
        samples_per_ray = measured_num_samples / self.rays_per_batch
        desired = int(self.config.target_num_samples / max(samples_per_ray, 1e-6))
        self.rays_per_batch = self._bucket(desired)
        return self.rays_per_batch
