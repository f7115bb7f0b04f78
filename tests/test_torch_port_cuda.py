"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: the f32 conv differs from the plain gather + GEMM in summation
order only (rtol 1e-5, atol 1e-4); s8 sums and greedy keep masks are exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as port_nms
from q3d_tpu_torch.ops.spconv import gather_conv

pytestmark = pytest.mark.cuda

CFG = Path(__file__).resolve().parent.parent / "tools" / "cfgs" / \
    "synthetic_models" / "centerpoint_tiny.yaml"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_gather_conv_kernel_matches_plain(card):
    rng = np.random.RandomState(0)
    n, m, cin, cout = 3000, 2500, 32, 64
    book = rng.randint(0, n + 1, size=(m, 27)).astype(np.int32)
    book[rng.rand(m, 27) < 0.7] = n                  # mostly misses
    idx = torch.from_numpy(book).to(card)
    valid = torch.from_numpy(rng.rand(m) > 0.1).to(card)
    for dt in (torch.float32, torch.bfloat16):
        f = torch.from_numpy(rng.randn(n, cin).astype(np.float32)).to(card, dt)
        w = torch.from_numpy(rng.randn(27, cin, cout).astype(np.float32)) \
            .to(card, dt)
        k = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid)
        p = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                           impl="plain")
        assert k.dtype == dt
        if dt == torch.float32:
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-4)
        else:                                        # one bf16 rounding apart
            torch.testing.assert_close(k.float(), p.float(), rtol=2 ** -7,
                                       atol=1e-2)
    fq = torch.from_numpy(rng.randint(-127, 128, (n, cin)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (27, cin, cout))
                          .astype(np.int8))
    fq, wq = fq.to(card), wq.to(card)
    scale = torch.rand(cout, device=card)
    for kw in ({}, {"out_scale": scale, "out_valid": valid}):
        assert torch.equal(
            gather_conv.sparse_gather_conv(fq, idx, wq, **kw),
            gather_conv.sparse_gather_conv(fq, idx, wq, impl="plain", **kw))


def test_greedy_nms_kernel_matches_plain(card):
    rng = np.random.RandomState(0)
    for k in (128, 200, 1024):
        iou = rng.rand(4, k, k).astype(np.float32) * (rng.rand(4, k, k) < 0.3)
        iou = torch.from_numpy(iou).to(card)
        valid = torch.from_numpy(rng.rand(4, k) > 0.1).to(card)
        for thresh in (0.1, 0.5):
            assert torch.equal(
                port_nms.greedy_nms(iou, valid, thresh),
                port_nms.greedy_nms(iou, valid, thresh, impl="plain"))


def test_tiny_model_kernels_match_plain(card):
    """centerpoint_tiny, seeded random weights, f32 without TF32: the model
    through its kernels equals the model through the plain versions."""
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=card)
    batch = load_data_to_device(next(iter(loader)), device=card)
    conv_launches = gather_conv.KERNEL.launches
    with torch.no_grad():
        out_k = model(dict(batch))
        model.set_kernel_impl("plain")
        out_p = model(dict(batch))
        model.set_kernel_impl(None)
    assert gather_conv.KERNEL.launches - conv_launches == 21
    for key in ("spatial_features", "spatial_features_2d"):
        torch.testing.assert_close(out_k[key], out_p[key], rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(out_k["final_valid"], out_p["final_valid"])
