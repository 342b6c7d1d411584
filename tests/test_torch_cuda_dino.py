"""DINO distillation, appearance embeddings and the new camera models on
the card against the CPU (``cuda`` marker; they skip without one).

This file imports torch and the port only, so it runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dino.py

Tolerances: DINO descriptors (ViT-S/8, 12 f32 layers, TF32 off) within
1e-4 of the largest descriptor; the query-chunked attention within 1e-5
of the whole one; a train step's losses rtol 1e-4, dense gradients rtol
1e-3 / atol 1e-5 and hash tables rtol 1e-2 / atol 1e-4 (f32 sums in
other orders; the tables' gradients accumulate by atomics on the card),
with patch size 1 so no conv-head ReLU sits at a rounding boundary; eval
outputs atol 1e-4; rays' directions atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from samnerf_tpu_torch.core.cameras import (EQUIRECTANGULAR, FISHEYE, PERSPECTIVE, Cameras,
                                            generate_rays)
from samnerf_tpu_torch.engine.trainer import TrainState, loss_and_grads
from samnerf_tpu_torch.models.sam_model import SAMModel, SAMModelConfig
from samnerf_tpu_torch.ops import hash_grid as hg
from samnerf_tpu_torch.preprocessing import get_dino_embeddings as gde
from samnerf_tpu_torch.utils.init import init_state
from samnerf_tpu_torch.utils.synthetic import look_at_c2w

SMALL = SAMModelConfig(
    num_levels=8, max_res=256, log2_hashmap_size=14,
    num_proposal_samples_per_ray=(16,), num_nerf_samples_per_ray=16,
    proposal_net_args=({"hidden_dim": 16, "log2_hashmap_size": 12,
                        "num_levels": 4, "max_res": 64},),
    hashgrid_layers=(4, 4), hashgrid_resolutions=((16, 64), (64, 128)),
    hashgrid_sizes=(14, 14), num_sam_samples=4, patch_size=1, hash_fn="morton")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(64, 64), (72, 96)])
def test_dino_descriptors_on_the_card_match_the_cpu(tmp_path, size):
    dev = _cuda()
    ckpt = tmp_path / "dino_vits8.pth"
    torch.save(gde.seeded_dino_state_dict("dino_vits8", seed=3), ckpt)
    img = np.random.default_rng(4).integers(0, 256, (*size, 3), dtype=np.uint8)
    out = {}
    for name, d, chunk in (("cpu", "cpu", None), ("card", dev, None), ("chunked", dev, 64)):
        ex = gde.ViTExtractor(checkpoint=str(ckpt), query_chunk=chunk, device=d)
        out[name] = ex.extract_descriptors(ex.preprocess(img), facet="key")
        assert ex.num_patches == tuple(1 + (s - 8) // 4 for s in size)
    scale = np.abs(out["cpu"]).max()
    assert np.abs(out["card"] - out["cpu"]).max() <= 1e-4 * scale
    assert np.abs(out["chunked"] - out["card"]).max() <= 1e-5 * scale


def _batch(rays, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, 3, rays), rng.integers(0, 64, rays),
                    rng.integers(0, 64, rays)], -1)
    return {"indices": idx, "image": rng.uniform(size=(rays, 3)).astype(np.float32),
            "sam": rng.normal(size=(rays, 256)).astype(np.float32),
            "dino": rng.normal(size=(rays, 384)).astype(np.float32),
            "clipseg": rng.normal(size=(rays, 192)).astype(np.float32)}


def _cameras(dev, ctype=None, dist=None):
    c2w = np.stack([look_at_c2w(np.array([1.5 * np.cos(a), 1.5 * np.sin(a), 0.5]),
                                np.zeros(3))[:3] for a in (0.0, 0.7, 1.4)]).astype(np.float32)
    return Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.full((3, 1), 50.0),
                   fy=torch.full((3, 1), 52.0), cx=torch.full((3, 1), 32.0),
                   cy=torch.full((3, 1), 31.5), width=64, height=64,
                   distortion_params=dist, camera_type=ctype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(use_dino_feature=True),
                                dict(use_appearance_embedding=True, num_images=3)])
def test_train_step_on_the_card_matches_the_cpu(kw):
    dev = _cuda()
    cfg = dataclasses.replace(SMALL, **kw)
    features = ("sam", "dino", "clipseg") if cfg.use_dino_feature else ("sam", "clipseg")
    batch = _batch(256)
    jitter = [np.random.default_rng(9 + i).uniform(size=(256, 1)).astype(np.float32)
              for i in range(2)]
    dist = torch.tensor([[0.03, -0.01, 0.0, 0.0, 0.001, 0.0]] * 3)
    outs = {}
    for d in (dev, "cpu"):
        model = SAMModel(cfg, device=d)
        model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                         torch.Generator().manual_seed(1), device=d,
                                         table_scale=0.5))
        hg.parity_hash_encode.launches = hg.parity_hash_encode_bwd.launches = 0
        ld, _, _ = loss_and_grads(
            model, cfg, TrainState(step=3), _cameras(d, dist=dist),
            {k: torch.as_tensor(v, device=d) for k, v in batch.items()}, features,
            jitter=[torch.as_tensor(j, device=d) for j in jitter])
        outs[str(d)] = ({k: v.item() for k, v in ld.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None},
                        (hg.parity_hash_encode.launches, hg.parity_hash_encode_bwd.launches))
    (la, ga, launches), (lb, gb, _) = outs[str(dev)], outs["cpu"]
    assert launches == (6, 6)
    assert set(la) == set(lb) and (("dino_loss" in la) == cfg.use_dino_feature)
    for k in lb:
        np.testing.assert_allclose(la[k], lb[k], rtol=1e-4, err_msg=k)
    assert set(ga) == set(gb)
    for n in gb:
        tol = (dict(rtol=1e-2, atol=1e-4) if n.endswith("table")
               else dict(rtol=1e-3, atol=1e-5))
        np.testing.assert_allclose(ga[n].numpy(), gb[n].numpy(), err_msg=n, **tol)


@pytest.mark.cuda
def test_eval_forward_with_dino_and_embeddings_on_the_card_matches_the_cpu():
    dev = _cuda()
    cfg = dataclasses.replace(SMALL, use_dino_feature=True, use_appearance_embedding=True,
                              num_images=3)
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (512, 2)))
    outs = {}
    for d in (dev, "cpu"):
        model = SAMModel(cfg, device=d)
        model.load_state_dict(init_state(SAMModel(cfg, device="meta"),
                                         torch.Generator().manual_seed(2), device=d,
                                         table_scale=0.5))
        rb = generate_rays(_cameras(d), torch.zeros(512, dtype=torch.long, device=d),
                           idx.to(d))
        outs[str(d)] = {k: v.cpu() for k, v in model(rb, ("sam", "dino", "clipseg")).items()
                        if k in ("rgb", "depth", "sam", "dino", "clipseg")}
    for k, v in outs["cpu"].items():
        np.testing.assert_allclose(outs[str(dev)][k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("ctype", [None, PERSPECTIVE, FISHEYE, EQUIRECTANGULAR])
def test_rays_on_the_card_match_the_cpu(ctype):
    dev = _cuda()
    dist = torch.tensor([[0.05, -0.02, 0.004, 0.001, 0.002, -0.001]] * 3)
    ct = None if ctype is None else torch.full((3, 1), ctype, dtype=torch.int32)
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 3, 4096))
    coords = torch.from_numpy(rng.integers(0, 64, (4096, 2)))
    cpu = generate_rays(_cameras("cpu", ct, dist), idx, coords)
    card = generate_rays(_cameras(dev, ct, dist), idx.to(dev), coords.to(dev))
    assert torch.equal(card.origins.cpu(), cpu.origins)
    np.testing.assert_allclose(card.directions.cpu().numpy(), cpu.directions.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.pixel_area.cpu().numpy(), cpu.pixel_area.numpy(),
                               rtol=1e-3)
