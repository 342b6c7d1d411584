"""Method presets from other packages.

Counterpart of ``samnerf_tpu/utils/plugins.py``: a package registers a
preset under the entry-point group ``samnerf_tpu_torch.method_configs``.
"""
from __future__ import annotations

from importlib.metadata import entry_points
from typing import Dict

ENTRY_POINT_GROUP = "samnerf_tpu_torch.method_configs"


def discover_methods() -> Dict[str, object]:
    """{name: preset} of every registered entry point; each resolves to a
    zero-argument callable giving a ``MethodConfig``, or to one."""
    methods: Dict[str, object] = {}
    for ep in entry_points(group=ENTRY_POINT_GROUP):
        obj = ep.load()
        methods[ep.name] = obj() if callable(obj) else obj
    return methods
