"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: the f32 conv differs from the plain gather + GEMM in summation
order only (rtol 1e-5, atol 1e-4); bf16 by one bf16 rounding of f32 sums
taken in another order (rtol 2^-7); s8 sums and greedy keep masks are exact.
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


# every (Cin, Cout) of the sparse backbone
BACKBONE_WIDTHS = [(16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
                   (64, 128), (128, 128)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "s8"])
@pytest.mark.parametrize("k", [27, 3])
@pytest.mark.parametrize("cin,cout", BACKBONE_WIDTHS)
def test_gather_conv_kernel_matches_plain(card, cin, cout, k, dtype):
    """M = 1000 is no multiple of the kernel's 128-row tile; rows 128-255
    (one whole tile) miss every tap; besides the book's own miss value N,
    some entries are negative or above N."""
    rng = np.random.RandomState(cin * 1000 + cout * 10 + k)
    n, m = 3000, 1000
    book = rng.randint(0, n, size=(m, k)).astype(np.int64)
    book[rng.rand(m, k) < 0.7] = n                   # mostly misses
    odd = rng.rand(m, k) < 0.05
    book[odd] = rng.choice([-1, -5, n + 1, 2 ** 31 - 1], size=int(odd.sum()))
    book[128:256] = n
    idx = torch.from_numpy(book.astype(np.int32)).to(card)
    valid = torch.from_numpy(rng.rand(m) > 0.1).to(card)
    scale = torch.from_numpy(rng.rand(cout).astype(np.float32)).to(card)
    if dtype == "s8":
        f = torch.from_numpy(rng.randint(-127, 128, (n, cin)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (k, cin, cout))
                             .astype(np.int8))
    else:
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        f = torch.from_numpy(rng.randn(n, cin).astype(np.float32)).to(dt)
        w = torch.from_numpy(rng.randn(k, cin, cout).astype(np.float32)).to(dt)
    f, w = f.to(card), w.to(card)
    for kw in ({}, {"out_scale": scale, "out_valid": valid}):
        launches = gather_conv.KERNEL.launches
        out_k = gather_conv.sparse_gather_conv(f, idx, w, **kw)
        out_p = gather_conv.sparse_gather_conv(f, idx, w, impl="plain", **kw)
        torch.cuda.synchronize()
        assert gather_conv.KERNEL.launches == launches + 1
        assert out_k.dtype == out_p.dtype and out_k.shape == (m, cout)
        assert not out_k[128:256].any()              # the all-miss tile
        if dtype == "s8":
            assert torch.equal(out_k, out_p)
        elif dtype == "f32":
            torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-4)
        else:                                        # one bf16 rounding apart
            torch.testing.assert_close(out_k.float(), out_p.float(),
                                       rtol=2 ** -7, atol=1e-2)


def test_gather_conv_wrapper_raises_on_what_no_instance_takes(card):
    book = torch.zeros((64, 27), dtype=torch.int32, device=card)
    w = torch.zeros((27, 16, 16), dtype=torch.bfloat16, device=card)
    buf = torch.zeros(64 * 16 + 1, dtype=torch.bfloat16, device=card)
    f = buf[1:].view(64, 16)                         # 2 bytes off alignment
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_conv.gather_conv_cuda(f, book, w)
    with pytest.raises(ValueError, match="no kernel instance"):
        gather_conv.gather_conv_cuda(
            torch.zeros((64, 48), dtype=torch.bfloat16, device=card), book,
            torch.zeros((27, 48, 16), dtype=torch.bfloat16, device=card))


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
