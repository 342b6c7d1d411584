"""Tiny widths for the model zoo's tests, in torch and the port only (no
JAX), so the card tests can use them too: ``tiny_configs`` patches every
zoo method's default config with a ``functools.partial`` of tiny widths,
``write_extras`` writes seeded depths and semantic masks beside a
synthetic scene's images."""
import functools

import numpy as np
from PIL import Image

SIZE = 24
NUM_CLASSES = 16


def write_extras(scene, depth_format="npy", size=SIZE):
    """Seeded depths (``.npy`` metres or 16-bit ``.png`` millimetres) and
    16-class semantic masks beside the scene's images."""
    rng = np.random.default_rng(0)
    (scene / "depths").mkdir(exist_ok=True)
    (scene / "semantics").mkdir(exist_ok=True)
    for img in sorted((scene / "images").glob("*.png")):
        depth = rng.uniform(0.5, 3.0, (size, size)).astype(np.float32)
        depth[0, :4] = 0.0                                    # pixels without depth
        if depth_format == "npy":
            np.save(scene / "depths" / f"{img.stem}.npy", depth)
        else:
            mm = np.round(depth * 1000).astype(np.uint16)
            Image.fromarray(mm).save(scene / "depths" / f"{img.stem}.png")
        classes = rng.integers(0, NUM_CLASSES, (size, size)).astype(np.uint8)
        Image.fromarray(classes).save(scene / "semantics" / f"{img.stem}.png")


TINY_BASE = dict(distill_sam=False, num_levels=2, max_res=32, log2_hashmap_size=10,
                 num_proposal_samples_per_ray=(8,), num_nerf_samples_per_ray=8,
                 proposal_net_args=({"hidden_dim": 8, "log2_hashmap_size": 10,
                                     "num_levels": 2, "max_res": 32},))


def tiny_configs(monkeypatch):
    """Patch every zoo method's default config to a tiny one."""
    from samnerf_tpu_torch.models import (depth_nerfacto, instant_ngp, mipnerf, nerfplayer,
                                          semantic_nerfw, tensorf, vanilla_nerf)
    from samnerf_tpu_torch.models.sam_model import SAMModelConfig
    patches = [
        (vanilla_nerf, "VanillaNerfConfig", dict(num_coarse_samples=4,
                                                 num_importance_samples=4, hidden_dim=16)),
        (mipnerf, "MipNerfConfig", dict(num_coarse_samples=4, num_importance_samples=4,
                                        hidden_dim=16, pos_frequencies=4)),
        (instant_ngp, "InstantNGPConfig", dict(num_samples=8, num_levels=2, max_res=32,
                                               log2_hashmap_size=10)),
        (tensorf, "TensoRFConfig", dict(num_uniform_samples=8, num_samples=4, resolution=8,
                                        density_components=2, color_components=2,
                                        appearance_dim=4)),
        (depth_nerfacto, "DepthNerfactoConfig", dict(base=SAMModelConfig(**TINY_BASE))),
        (semantic_nerfw, "SemanticNerfWConfig", dict(base=SAMModelConfig(**TINY_BASE))),
        (nerfplayer, "NerfPlayerConfig", dict(num_samples=8, num_levels=2, max_res=32,
                                              log2_hashmap_size=10, num_time_steps=2,
                                              hidden_dim=8)),
    ]
    for mod, name, kw in patches:
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))
