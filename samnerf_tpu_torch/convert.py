"""Weights from the JAX package: a flax param tree -> the port's state dict.

``params_from_jax`` takes the tree as nested dicts of numpy arrays (with
or without the top-level ``"params"`` key) of either a ``SAMModel`` or a
decoder-only ``Sam`` and returns the state dict of the port's module.
Both packages then compute the same function.

- names: ``Dense_i`` -> ``layers.i``, ``Conv_i`` -> ``convs.i``,
  ``ParityHashEncoding_0`` -> ``encoding``, ``MLP_0`` -> ``mlp``; any
  other ``name_i`` -> ``name.i`` (``proposal_networks_0``, ``sam_enc_1``,
  and every SAM list, which gives the reference torch SAM's names);
- ``Dense`` kernels [in, out] -> ``Linear.weight`` [out, in];
- ``Conv`` kernels HWIO -> OIHW;
- ``ConvTranspose`` kernels (the mask decoder's ``output_upscaling``)
  -> torch [in, out, kh, kw], spatially flipped back: the inverse of
  ``build_sam._conv_t``;
- ``LayerNorm`` ``scale`` -> ``weight``; ``Embed`` ``embedding`` ->
  ``weight``;
- hash ``table``, ``qtable{b}``, ``qscales{b}`` and everything else pass
  through unchanged (the JAX package owns the table layout).
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

_MODULE_NAMES = {"ParityHashEncoding_0": "encoding", "MLP_0": "mlp"}
_LIST_NAMES = {"Dense": "layers", "Conv": "convs"}
_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _module_name(key: str) -> str:
    if key in _MODULE_NAMES:
        return _MODULE_NAMES[key]
    m = _INDEXED.match(key)
    if m:
        return f"{_LIST_NAMES.get(m.group(1), m.group(1))}.{m.group(2)}"
    return key


def _leaf(path, key: str, value: np.ndarray):
    value = np.asarray(value)
    if key == "kernel":
        if value.ndim == 2:
            value = value.T
        elif "output_upscaling" in path[-1]:
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            value = value.transpose(3, 2, 0, 1)
        key = "weight"
    elif key in ("scale", "embedding"):
        key = "weight"
    return key, torch.from_numpy(np.array(value, order="C"))   # a writable copy


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays) -> flat state dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            else:
                name, t = _leaf(path, key, value)
                state[".".join([_module_name(p) for p in path] + [name])] = t

    walk(tree, ())
    return state
