"""The model zoo on the card against the CPU (``cuda`` marker; they skip
without one): a small instant-NGP train step with its occupancy grid, and
F32-ENC / F32-ENC-BWD against their plain versions at instant-NGP's pack
layout (one 16-level pyramid of one pack, 2^19 rows, the reference
hash).

This file imports torch and the port only, so it runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_zoo.py

Tolerances: losses rtol 1e-4, dense gradients rtol 1e-3 / atol 1e-5 and
hash tables rtol 1e-2 / atol 1e-4 (f32 sums in other orders; the card
adds table gradients with atomics where the CPU rounds the plain
version's sum to bf16), eval outputs atol 1e-4; F32-ENC within 1e-5 of
its plain version, F32-ENC-BWD rtol 1e-2 / atol 1e-4.
"""
import numpy as np
import pytest
import torch

from samnerf_tpu_torch.configs import zoo
from samnerf_tpu_torch.core.cameras import Cameras, generate_rays
from samnerf_tpu_torch.models.instant_ngp import InstantNGPConfig, InstantNGPModel
from samnerf_tpu_torch.ops import hash_grid as hg
from samnerf_tpu_torch.ops.encodings import hash_grid_scalings
from samnerf_tpu_torch.ops.occupancy import update_occupancy

SMALL = InstantNGPConfig(num_samples=48, log2_hashmap_size=14)
RAYS = 256
H = W = 32


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cameras(device):
    c2w = torch.tensor([[[1.0, 0, 0, 0.05], [0, 1, 0, -0.02], [0, 0, 1, 0.6]]])
    return Cameras(camera_to_worlds=c2w, fx=torch.tensor([[30.0]]), fy=torch.tensor([[30.0]]),
                   cx=torch.tensor([[W / 2.0]]), cy=torch.tensor([[H / 2.0]]),
                   width=W, height=H).to(device)


@pytest.mark.cuda
def test_instant_ngp_step_on_the_card_matches_the_cpu():
    dev = _cuda()
    gen = torch.Generator().manual_seed(0)
    state = {k: (v * 2000.0 if k.endswith("table") else v)      # features away from 0
             for k, v in zoo.init_zoo_params(InstantNGPModel(SMALL, device="meta"), gen,
                                             "cpu").items()}
    g = torch.Generator().manual_seed(1)
    idx = torch.stack([torch.zeros(RAYS, dtype=torch.long),
                       torch.randint(0, H, (RAYS,), generator=g),
                       torch.randint(0, W, (RAYS,), generator=g)], -1)
    batch = {"indices": idx, "image": torch.rand((RAYS, 3), generator=g)}
    draws = {"jitter": (torch.rand((RAYS, 1), generator=g),),
             "bg_rgb": torch.rand((RAYS, 3), generator=g)}
    cells, jitter = torch.randint(0, 16 ** 3, (2048,), generator=g), torch.rand((2048, 3),
                                                                             generator=g)
    method = zoo.zoo_methods()["instant-ngp"]
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = InstantNGPModel(SMALL, device=d)
        model.load_state_dict(state)
        _, grid = update_occupancy(torch.full((16 ** 3,), 0.005, device=d), model.density_fn,
                                   model.aabb, idx=cells.to(d), jitter=jitter.to(d))
        hg.parity_hash_encode.launches = hg.parity_hash_encode_bwd.launches = 0
        losses, _ = zoo.zoo_loss_and_grads(
            method, model, SMALL, _cameras(d), {k: v.to(d) for k, v in batch.items()},
            occupancy=grid, draws={"jitter": (draws["jitter"][0].to(d),),
                                   "bg_rgb": draws["bg_rgb"].to(d)})
        launches = (hg.parity_hash_encode.launches, hg.parity_hash_encode_bwd.launches)
        rb = generate_rays(_cameras(d), idx[:, 0].to(d), idx[:, 1:].to(d))
        ev = model(rb, train=False, occupancy=grid)
        out[name] = dict(grid=grid.cpu(), launches=launches,
                         losses={k: v.item() for k, v in losses.items()},
                         grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                         eval={k: v.cpu() for k, v in ev.items()})
    cpu, card = out["cpu"], out["card"]
    assert card["launches"] == (1, 1) and cpu["launches"] == (0, 0)   # the step
    assert torch.equal(cpu["grid"], card["grid"]) and 0 < float(cpu["grid"].mean()) < 1
    for k, v in cpu["losses"].items():
        np.testing.assert_allclose(card["losses"][k], v, rtol=1e-4, err_msg=k)
    for n, ref in cpu["grads"].items():
        tol = dict(rtol=1e-2, atol=1e-4) if n.endswith("table") else dict(rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(card["grads"][n].numpy(), ref.numpy(), err_msg=n, **tol)
    for k, v in cpu["eval"].items():
        np.testing.assert_allclose(card["eval"][k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 4096 * 48])
def test_f32_kernels_at_instant_ngp_layout(n):
    """One 16-level pyramid of one pack at 2^19 rows (512 steps), the
    reference hash: the grid update's 65,536 queries and a train step's
    encode of 4096 rays x 48 samples."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(2)
    scalings = tuple(hash_grid_scalings(16, 16, 2048).tolist())
    table = hg.init_parity_table(gen, 16, 512, 1, scale=0.5, device=dev)
    pos = torch.rand((n, 3), generator=gen, device=dev)
    g = torch.randn((n, 32), generator=gen, device=dev)
    out = hg.parity_hash_encode(table, pos, scalings, 512, "reference")
    ref = hg.parity_hash_encode_ref(table, pos, scalings, 512, "reference")
    assert (out - ref).abs().max().item() <= 1e-5
    grad = hg.parity_hash_encode_bwd(g, pos, scalings, 512, "reference")
    grad_ref = hg.parity_hash_encode_bwd_ref(g, pos, scalings, 512, "reference")
    torch.testing.assert_close(grad, grad_ref, rtol=1e-2, atol=1e-4)
