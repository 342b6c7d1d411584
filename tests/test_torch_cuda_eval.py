"""The port's eval metrics and automatic mask generator on the card
against the CPU (``cuda`` marker; they skip without one).

This file imports torch and the port only, so it runs on a machine with
a card and no JAX (``tests/conftest.py`` imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_eval.py

Tolerances: SSIM and PSNR rtol 1e-5 (f32 sums in another order); LPIPS
rtol 1e-4 on seeded VGG16 weights (thirteen f32 convolutions, TF32 off);
``generate`` of a small SAM (its global layer through FLASH-RELPOS on the
card, the plain version on the CPU): the same number of annotations,
boxes within 1 px and each mask at IoU >= 0.99 with its CPU counterpart.
"""
import numpy as np
import pytest
import torch

from samnerf_tpu_torch.ops import attention as ta
from samnerf_tpu_torch.perception.sam.automatic_mask_generator import \
    SamAutomaticMaskGenerator
from samnerf_tpu_torch.perception.sam.image_encoder import ImageEncoderViT
from samnerf_tpu_torch.perception.sam.predictor import SamPredictor
from samnerf_tpu_torch.perception.sam.sam import Sam
from samnerf_tpu_torch.utils import metrics
from samnerf_tpu_torch.utils.init import init_state

SMALL_ENCODER = dict(img_size=256, patch_size=16, embed_dim=160, depth=4, num_heads=2,
                     mlp_ratio=4.0, out_chans=256, window_size=7, global_attn_indexes=(2,),
                     flash_min_tokens=256)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, a.shape), 0.0, 1.0).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (127, 93), (512, 512)])
def test_psnr_and_ssim_on_the_card_match_the_cpu(hw):
    dev = _cuda()
    a, b = _images(*hw)
    for fn in (metrics.psnr, metrics.ssim):
        np.testing.assert_allclose(fn(a.to(dev), b.to(dev)).item(), fn(a, b).item(),
                                   rtol=1e-5, err_msg=fn.__name__)


def lpips_state(seed=0):
    """Seeded LPIPS weights in the port's layout (He-normal VGG16
    convolutions, non-negative heads)."""
    model = metrics.LPIPS(device="meta")
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.startswith("lins."):
            v = np.abs(rng.normal(0.0, 0.1, shape))
        elif name.endswith("bias"):
            v = rng.normal(0.0, 0.01, shape)
        else:
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 64), (75, 101), (512, 512)])
def test_lpips_on_the_card_matches_the_cpu(hw):
    dev = _cuda()
    state = lpips_state()
    cpu, card = metrics.LPIPS(device="cpu"), metrics.LPIPS(device=dev)
    cpu.load_state_dict(state)
    card.load_state_dict(state)
    a, b = _images(*hw, seed=1)
    want = metrics.lpips(a, b, cpu).item()
    assert want > 0.0
    np.testing.assert_allclose(metrics.lpips(a.to(dev), b.to(dev), card).item(), want,
                               rtol=1e-4)


def small_sam(device, seed=0):
    """A seeded SAM whose 16x16-token encoder runs its global layer through
    FLASH-RELPOS on the card."""
    meta = Sam(image_encoder=ImageEncoderViT(**SMALL_ENCODER, device="meta"), device="meta")
    sam = Sam(image_encoder=ImageEncoderViT(**SMALL_ENCODER, device=device), device=device)
    sam.load_state_dict(init_state(meta, torch.Generator().manual_seed(seed), device))
    return sam


def match_annotations(card, cpu):
    """Pair each card annotation with the CPU one of the same prompt point
    and the highest mask IoU; returns (worst IoU, worst box difference)."""
    assert len(card) == len(cpu)
    worst_iou, worst_box = 1.0, 0.0
    for a in card:
        same_point = [b for b in cpu if np.allclose(b["point_coords"], a["point_coords"])]
        ious = [np.logical_and(a["segmentation"], b["segmentation"]).sum()
                / max(np.logical_or(a["segmentation"], b["segmentation"]).sum(), 1)
                for b in same_point]
        best = int(np.argmax(ious))
        worst_iou = min(worst_iou, float(ious[best]))
        worst_box = max(worst_box, float(np.abs(np.subtract(a["bbox"],
                                                            same_point[best]["bbox"])).max()))
    return worst_iou, worst_box


@pytest.mark.cuda
def test_generate_on_the_card_matches_the_cpu():
    dev = _cuda()
    image = np.random.default_rng(2).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, box_nms_thresh=1.0)
    before = ta.flash_attention_relpos.launches
    card = SamAutomaticMaskGenerator(SamPredictor(small_sam(dev)), **kw).generate(image)
    # one encode: the encode graph's eager run and its capture (one global layer)
    assert ta.flash_attention_relpos.launches == before + 2
    cpu = SamAutomaticMaskGenerator(SamPredictor(small_sam("cpu")), **kw).generate(image)
    assert len(card) == 16 * 3
    worst_iou, worst_box = match_annotations(card, cpu)
    assert worst_iou >= 0.99 and worst_box <= 1.0, (worst_iou, worst_box)
