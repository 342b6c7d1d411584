"""Which bf16 FLASH-RELPOS kernel a call takes (``ops/attention.py``
``bf16_route``): the wgmma kernel where SAM's global layers run (a 64-wide
token grid, head dims that are a multiple of 8 up to ``MAX_HEAD_DIM``, q,
k and v 16-byte aligned for TMA), the ``mma.sync`` kernel for every
other shape the wrapper takes.  A pure function of (head dim, grid width,
alignment), so the CPU holds the contract the card runs."""
import pytest
import torch

from samnerf_tpu_torch.ops import attention as tap


@pytest.mark.parametrize("d", [80, 64, 128, 8, 16, 24, 96])
def test_sam_global_layers_take_the_wgmma_kernel(d):
    """ViT-H (D = 80), ViT-B and ViT-L (D = 64), the widest head (128) and
    the smaller multiples of 8, on SAM's 64 x 64 grid."""
    assert tap.bf16_route(d, 64, True) == "wgmma"


@pytest.mark.parametrize("d,kw,aligned", [
    (20, 64, True),          # D % 8 != 0: rows are not a multiple of 16 bytes
    (33, 64, True), (1, 64, True),
    (136, 64, True),         # past MAX_HEAD_DIM
    (80, 16, True),          # a key tile of 64 is not one grid row
    (64, 128, True), (80, 7, True),
    (80, 64, False), (64, 64, False)])   # misaligned operands
def test_other_shapes_take_the_mma_sync_kernel(d, kw, aligned):
    assert tap.bf16_route(d, kw, aligned) == "mma_sync"


def test_the_route_covers_the_head_dims_the_wrapper_takes():
    """Every multiple of 8 up to ``MAX_HEAD_DIM`` (the limit the wrapper
    checks) takes the wgmma kernel on a 64-wide grid, and nothing past it."""
    assert tap.MAX_HEAD_DIM == 128
    wgmma = [d for d in range(1, 2 * tap.MAX_HEAD_DIM) if tap.bf16_route(d, 64, True) == "wgmma"]
    assert wgmma == list(range(8, tap.MAX_HEAD_DIM + 1, 8))


def test_cpu_tensors_launch_no_kernel():
    """On the CPU the wrapper runs the plain version and counts nothing,
    whatever the route would be."""
    before = (tap.flash_attention_relpos.launches, tap.flash_attention_relpos.launches_bf16,
              tap.flash_attention_relpos.launches_bf16_wgmma)
    q = torch.zeros((1, 128, 80), dtype=torch.bfloat16)
    rel_h = torch.zeros((1, 128, 2), dtype=torch.bfloat16)
    rel_w = torch.zeros((1, 128, 64), dtype=torch.bfloat16)
    out = tap.flash_attention_relpos(q, q, q, rel_h, rel_w, 80 ** -0.5)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 128, 80)
    assert (tap.flash_attention_relpos.launches, tap.flash_attention_relpos.launches_bf16,
            tap.flash_attention_relpos.launches_bf16_wgmma) == before
