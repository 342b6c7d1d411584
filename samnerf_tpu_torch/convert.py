"""Weights from the JAX package: a flax param tree -> the port's state dict.

``params_from_jax`` takes the tree as nested dicts of numpy arrays (with
or without the top-level ``"params"`` key) of either a ``SAMModel`` or a
decoder-only ``Sam`` and returns the state dict of the port's module.
Both packages then compute the same function.

- names: ``Dense_i`` -> ``layers.i``, ``Conv_i`` -> ``convs.i``,
  ``ParityHashEncoding_0`` -> ``encoding``, ``MLP_0`` -> ``mlp``; the
  image encoder's ``patch_embed`` -> ``patch_embed.proj`` and
  ``neck_conv1`` / ``neck_ln1`` / ``neck_conv2`` / ``neck_ln2`` ->
  ``neck.0`` .. ``neck.3``; any other ``name_i`` -> ``name.i``
  (``proposal_networks_0``, ``sam_enc_1``, ``blocks_7`` and every SAM
  list, which gives the reference torch SAM's names);
- ``Dense`` kernels [in, out] -> ``Linear.weight`` [out, in];
- ``Conv`` kernels HWIO -> OIHW;
- ``ConvTranspose`` kernels (the mask decoder's ``output_upscaling``)
  -> torch [in, out, kh, kw], spatially flipped back: the inverse of
  ``build_sam._conv_t``;
- ``LayerNorm`` ``scale`` -> ``weight``; ``Embed`` ``embedding`` ->
  ``weight`` (the nerfacto field's ``embedding_appearance`` [images, 32]
  keeps its layout; the DINO head ``sam_field.dino_net`` is an ``MLP``
  like the others);
- hash ``table``, ``qtable{b}``, ``qscales{b}``, the encoder's
  ``pos_embed`` ([1, 64, 64, C] in both) and ``rel_pos_*`` and
  everything else pass through unchanged.

``zoo_params_from_jax`` does the same for a model of the zoo
(``configs/zoo.py``): their flax names already map to the port's.

``train_checkpoint_from_jax`` bridges a whole training checkpoint of the
JAX ``Trainer`` (parameters, optax Adam moments, step) to the port's.

``clip_state_dict_from_jax`` and ``clipseg_state_dict_from_jax`` go the
other way for CLIP and ClipSeg, whose modules keep the reference names:
JAX params -> the reference layouts (OpenAI CLIP's state dict,
``rd64-uni.pth``'s decoder keys), the exact inverses of the JAX package's
``convert_clip_state_dict`` and ``convert_clipseg_state_dict``.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

_MODULE_NAMES = {"ParityHashEncoding_0": "encoding", "MLP_0": "mlp",
                 "patch_embed": "patch_embed.proj", "neck_conv1": "neck.0",
                 "neck_ln1": "neck.1", "neck_conv2": "neck.2", "neck_ln2": "neck.3"}
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


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays) -> flat state dict.
    Leaves that are tuples (optax's ``MaskedNode``, which stands in a
    group's moment tree for another group's parameter) are skipped."""
    tree = _unwrap(tree)
    state: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            elif not isinstance(value, tuple):
                name, t = _leaf(path, key, value)
                state[".".join([_module_name(p) for p in path] + [name])] = t

    walk(tree, ())
    return state


_ZOO_TOP_LEVEL = {
    "vanilla-nerf": {"field_coarse", "field_fine"}, "mipnerf": {"field"},
    "instant-ngp": {"field"}, "tensorf": {"field"},
    "depth-nerfacto": {"fields", "proposal_networks"},
    "semantic-nerfw": {"backbone", "semantic_head"},
    "nerfplayer-nerfacto": {"field"}, "nerfplayer-ngp": {"field"}}


def zoo_params_from_jax(name: str, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax params of zoo method ``name``'s model -> the port model's
    state dict.  :func:`params_from_jax` with no renames: the port names
    its modules as the flax ones (``field.mlp_base.layers.0``,
    ``field.density_planes``, ``backbone.proposal_networks.0``).  Raises
    when the tree's top-level modules are not that method's."""
    if name not in _ZOO_TOP_LEVEL:
        raise KeyError(f"unknown zoo method {name!r}")
    state = params_from_jax(tree)
    top = {k.split(".", 1)[0] for k in state}
    if top != _ZOO_TOP_LEVEL[name]:
        raise ValueError(f"{name} params have top-level modules {sorted(top)}, "
                         f"not {sorted(_ZOO_TOP_LEVEL[name])}")
    return state


def _adam_states(node):
    """Every optax ``ScaleByAdamState`` (a named tuple with ``count``,
    ``mu`` and ``nu``) in an optimizer state, depth first."""
    fields = getattr(node, "_fields", None)
    if fields is not None and {"count", "mu", "nu"} <= set(fields):
        yield node
    elif isinstance(node, Mapping):
        for value in node.values():
            yield from _adam_states(value)
    elif isinstance(node, (list, tuple)):
        for value in node:
            yield from _adam_states(value)


def train_checkpoint_from_jax(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX ``Trainer`` checkpoint -> the port's ``Trainer`` checkpoint.

    ``ckpt`` is what ``samnerf_tpu/engine/trainer.py:save_checkpoint``
    writes (``params``, ``opt_state``, ``step``, ``steps_since_update``),
    restored with the JAX trainer's own template and fetched with
    ``jax.device_get``, so ``opt_state`` keeps optax's containers: an
    ``optax.multi_transform`` holds one masked Adam state per group (with
    ``MaskedNode`` for the other groups' leaves, and an empty state before
    it where the group clips).  Returns ``{"model", "optimizer", "step",
    "steps_since_update"}`` as ``Trainer.save_checkpoint`` writes it:
    parameters through :func:`params_from_jax`; each group's ``mu`` and
    ``nu`` through the same renames and layout changes as torch Adam's
    ``exp_avg`` and ``exp_avg_sq``; optax's update ``count`` as
    ``GroupedAdam.count`` and each parameter's ``step``."""
    model = params_from_jax(ckpt["params"])
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    counts = set()
    for adam in _adam_states(ckpt["opt_state"]):
        count = int(np.asarray(adam.count))
        counts.add(count)
        mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
        for name, m in mu.items():
            if name in moments:
                raise ValueError(f"{name} has moments in two optimizer groups")
            moments[name] = {"step": torch.tensor(float(count)), "exp_avg": m,
                             "exp_avg_sq": nu[name]}
    if not moments:
        raise ValueError("no Adam state in opt_state: restore the checkpoint with the "
                         "JAX Trainer's template (Trainer.load_checkpoint)")
    if len(counts) != 1:
        raise ValueError(f"optimizer groups at different update counts: {sorted(counts)}")
    if set(moments) != set(model):
        raise ValueError("Adam moments and parameters differ: "
                         f"{sorted(set(moments) ^ set(model))}")
    return {"model": model,
            "optimizer": {"optimizer": {"state": moments}, "count": counts.pop()},
            "step": int(ckpt["step"]),
            "steps_since_update": int(ckpt["steps_since_update"])}


# --- ClipSeg: the inverses of the JAX package's ``convert_clip_state_dict``
# and ``convert_clipseg_state_dict``, back to the reference layouts --------


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def _dense(node, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _tensor(np.asarray(node["kernel"]).T),
            f"{name}.bias": _tensor(node["bias"])}


def _norm(node, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _tensor(node["scale"]), f"{name}.bias": _tensor(node["bias"])}


def _attention(in_proj, out_proj, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.in_proj_weight": _tensor(np.asarray(in_proj["kernel"]).T),
            f"{name}.in_proj_bias": _tensor(in_proj["bias"]),
            **_dense(out_proj, f"{name}.out_proj")}


def _indexed(tree: Mapping[str, Any], name: str) -> int:
    return sum(1 for k in tree if _INDEXED.match(k) and k.rsplit("_", 1)[0] == name)


def clip_state_dict_from_jax(visual_params: Mapping[str, Any],
                             text_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPVisual`` and ``CLIPText`` params -> an OpenAI CLIP state
    dict (the visual tower under ``visual.``): Dense kernels transposed
    back, the patch conv HWIO -> OIHW."""
    vis, txt = _unwrap(visual_params), _unwrap(text_params)

    def blocks(tree, prefix):
        out = {}
        for i in range(_indexed(tree, "resblocks")):
            b, name = tree[f"resblocks_{i}"], f"{prefix}transformer.resblocks.{i}"
            out.update(_norm(b["ln_1"], f"{name}.ln_1"), **_norm(b["ln_2"], f"{name}.ln_2"),
                       **_attention(b["attn_in_proj"], b["attn_out_proj"], f"{name}.attn"),
                       **_dense(b["mlp_c_fc"], f"{name}.mlp.c_fc"),
                       **_dense(b["mlp_c_proj"], f"{name}.mlp.c_proj"))
        return out

    return {"visual.conv1.weight": _tensor(np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1)),
            "visual.class_embedding": _tensor(vis["class_embedding"]),
            "visual.positional_embedding": _tensor(vis["positional_embedding"]),
            **_norm(vis["ln_pre"], "visual.ln_pre"), **_norm(vis["ln_post"], "visual.ln_post"),
            "visual.proj": _tensor(vis["proj"]), **blocks(vis, "visual."),
            "token_embedding.weight": _tensor(txt["token_embedding"]["embedding"]),
            "positional_embedding": _tensor(txt["positional_embedding"]),
            **_norm(txt["ln_final"], "ln_final"),
            "text_projection": _tensor(txt["text_projection"]), **blocks(txt, "")}


def clipseg_state_dict_from_jax(decoder_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPDensePredT`` params -> ``rd64-uni.pth``'s decoder keys:
    Dense kernels transposed back, ``trans_conv`` flipped back to the
    reference ``ConvTranspose2d``'s [in, out, kh, kw]."""
    p = _unwrap(decoder_params)
    sd = {**_dense(p["film_mul"], "film_mul"), **_dense(p["film_add"], "film_add"),
          "trans_conv.weight": _tensor(
              np.asarray(p["trans_conv"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)),
          "trans_conv.bias": _tensor(p["trans_conv"]["bias"])}
    for i in range(_indexed(p, "reduces")):
        b, name = p[f"blocks_{i}"], f"blocks.{i}"
        sd.update(_dense(p[f"reduces_{i}"], f"reduces.{i}"),
                  **_attention(b["self_attn_in_proj"], b["self_attn_out_proj"],
                               f"{name}.self_attn"),
                  **_dense(b["linear1"], f"{name}.linear1"),
                  **_dense(b["linear2"], f"{name}.linear2"),
                  **_norm(b["norm1"], f"{name}.norm1"), **_norm(b["norm2"], f"{name}.norm2"))
    return sd
