"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances: the f32 conv differs from the plain gather + GEMM in summation
order only (rtol 1e-5, atol 1e-4); bf16 by one bf16 rounding of f32 sums
taken in another order (rtol 2^-7); s8 sums and greedy keep masks are exact,
and the IoU that greedy NMS's boxes form computes is bit-equal to the plain
``boxes_iou_bev``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.ops.iou3d_nms import boxes_iou_bev
from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as port_nms
from q3d_tpu_torch.ops.iou3d_nms import iou3d_nms_utils
from q3d_tpu_torch.ops.pointnet2_utils import (ball_query,
                                               farthest_point_sample)
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
        launches = sum(gather_conv.KERNEL.launches.values())
        out_k = gather_conv.sparse_gather_conv(f, idx, w, **kw)
        out_p = gather_conv.sparse_gather_conv(f, idx, w, impl="plain", **kw)
        torch.cuda.synchronize()
        assert sum(gather_conv.KERNEL.launches.values()) == launches + 1
        assert out_k.dtype == out_p.dtype and out_k.shape == (m, cout)
        assert not out_k[128:256].any()              # the all-miss tile
        if dtype == "s8":
            assert torch.equal(out_k, out_p)
        elif dtype == "f32":
            torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-4)
        else:                                        # one bf16 rounding apart
            torch.testing.assert_close(out_k.float(), out_p.float(),
                                       rtol=2 ** -7, atol=1e-2)


def _bev_tensor(rng, card, n_cap, n_valid, c, shape=(180, 180)):
    """A batch-2 2D sparse tensor (VoxelNeXt's stride-8 BEV rows at
    nuScenes width): n_valid unique cells of B x 180 x 180, the rest of the
    n_cap rows padding, rows sorted by key, on the card."""
    from q3d_tpu_torch.ops.spconv import SparseConvTensor
    cells = int(np.prod(shape))
    flat = rng.choice(2 * cells, n_valid, replace=False)
    b, rest = np.divmod(flat, cells)
    y, x = np.divmod(rest, shape[1])
    idx = np.full((n_cap, 3), -1, np.int32)
    idx[:n_valid] = np.stack([b, y, x], 1)
    feats = rng.randn(n_cap, c).astype(np.float32)
    feats[n_valid:] = 0.0
    return SparseConvTensor(torch.from_numpy(feats).to(card),
                            torch.from_numpy(idx).to(card), shape,
                            2).sort_rows()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "s8"])
@pytest.mark.parametrize("kind", ["subm", "stride1"])
def test_gather_conv_2d_books_match_plain(card, kind, dtype):
    """VoxelNeXt's 2D convs: K = 9, 128 -> 128, over 960,000 rows, most of
    them padding (3 x 2 x 160,000, as the merged BEV tensor's capacity);
    the SubMConv2d book and the stride-1 SparseConv2d book (its outputs the
    dilation of its inputs)."""
    from q3d_tpu_torch.ops.spconv import engine
    rng = np.random.RandomState(9 + len(kind) + len(dtype))
    st = _bev_tensor(rng, card, 960_000, 40_000, 128)
    if kind == "subm":
        idx, valid = engine.subm_gather_indices(st, 3), None
    else:
        out_idx, idx, _ = engine.sparse_conv_downsample(st, 3, 1, 1)
        valid = out_idx[:, 0] >= 0
        assert 40_000 < int(valid.sum()) < 960_000
    assert idx.shape == (960_000, 9)
    f = st.features
    w = torch.from_numpy(rng.randn(9, 128, 128).astype(np.float32) / 30.0)
    w = w.to(card)
    if dtype == "s8":
        f = torch.clamp(torch.round(f * 40), -127, 127).to(torch.int8)
        w = torch.clamp(torch.round(w * 300), -127, 127).to(torch.int8)
    elif dtype == "bf16":
        f, w = f.to(torch.bfloat16), w.to(torch.bfloat16)
    launches = sum(gather_conv.KERNEL.launches.values())
    out_k = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid)
    out_p = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                           impl="plain")
    torch.cuda.synchronize()
    assert sum(gather_conv.KERNEL.launches.values()) == launches + 1
    if dtype == "s8":
        assert torch.equal(out_k, out_p)
    elif dtype == "f32":
        torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-4)
    else:
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


WIDTHS = (16, 32, 64, 128)


@pytest.mark.parametrize("identity", ["none", "s8", "f32", "bf16"])
@pytest.mark.parametrize("k", [27, 3])
@pytest.mark.parametrize("cout", WIDTHS)
@pytest.mark.parametrize("cin", WIDTHS)
def test_gather_conv_requant_kernel_matches_plain(card, cin, cout, k,
                                                  identity):
    """The fused s8 entry (conv, BN fold, residual, ReLU, row mask, requant)
    against ``gather_conv_requant_plain``, bit for bit, with and without a
    row mask.  Scales are drawn so that y / s spans the int8 range and
    clips at the top; a bf16 identity is taken as f32."""
    rng = np.random.RandomState(cin * 1000 + cout * 10 + k)
    n, m = 3000, 1000
    book = rng.randint(0, n, size=(m, k)).astype(np.int64)
    book[rng.rand(m, k) < 0.7] = n
    book[128:256] = n
    idx = torch.from_numpy(book.astype(np.int32)).to(card)
    f = torch.from_numpy(rng.randint(-127, 128, (n, cin)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, cin, cout)).astype(np.int8))
    f, w = f.to(card), w.to(card)
    out_scale = torch.from_numpy(
        (rng.uniform(0.5, 1.5, cout) / (127.0 ** 2 * np.sqrt(0.3 * k * cin)))
        .astype(np.float32)).to(card)
    kf = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(card)
    bf = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.3).to(card)
    out_valid = torch.from_numpy(rng.rand(m) > 0.1).to(card)
    row_valid = out_valid & torch.from_numpy(rng.rand(m) > 0.1).to(card)
    ident, id_scale = None, None
    if identity == "s8":
        ident = torch.from_numpy(rng.randint(-127, 128, (m, cout))
                                 .astype(np.int8)).to(card)
        id_scale = torch.tensor(0.01, device=card)
    elif identity != "none":
        ident = torch.from_numpy(rng.randn(m, cout).astype(np.float32)).to(card)
        ident = ident.to(getattr(torch, {"f32": "float32",
                                         "bf16": "bfloat16"}[identity]))
    for rv in (None, row_valid):
        y = gather_conv.epilogue_f32(
            gather_conv.gather_conv_plain(f, idx, w, out_scale, out_valid),
            kf, bf, rv, ident, id_scale)
        s = (y.abs().amax() * 0.8 / 127).reshape(())
        args = (f, idx, w, out_scale, kf, bf, s)
        kw = dict(out_valid=out_valid, row_valid=rv, identity=ident,
                  identity_scale=id_scale)
        launches = gather_conv.KERNEL.launches[gather_conv.REQUANT_ENTRY]
        q_k = gather_conv.sparse_gather_conv_requant(*args, **kw)
        q_p = gather_conv.sparse_gather_conv_requant(*args, impl="plain", **kw)
        torch.cuda.synchronize()
        assert gather_conv.KERNEL.launches[gather_conv.REQUANT_ENTRY] \
            == launches + 1
        assert q_k.dtype == torch.int8 and q_k.shape == (m, cout)
        assert int(q_p.eq(127).sum()) > 0 and int(q_p.ne(0).sum()) > m
        assert torch.equal(q_k, q_p)


def test_gather_conv_requant_wrapper_raises(card):
    f = torch.zeros((64, 16), dtype=torch.int8, device=card)
    book = torch.zeros((64, 27), dtype=torch.int32, device=card)
    w = torch.zeros((27, 16, 16), dtype=torch.int8, device=card)
    v = torch.ones(16, device=card)
    s = torch.tensor(0.1, device=card)
    with pytest.raises(ValueError, match="needs out_scale"):
        gather_conv.gather_conv_requant_cuda(f, book, w, None, v, v, s)
    with pytest.raises(ValueError, match="takes s8"):
        gather_conv.gather_conv_requant_cuda(f.float(), book, w.float(), v, v,
                                             v, s)
    with pytest.raises(ValueError, match="needs its scale"):
        gather_conv.gather_conv_requant_cuda(f, book, w, v, v, v, s,
                                             identity=f)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gather_conv.gather_conv_requant_cuda(
            f, book, w, v, v, v, s, identity=f.to(torch.float16))


def test_int8_conv2d_int_mm_matches_exact_product(card):
    """The dense int8 conv through ``torch._int_mm`` (a 3x3 conv of a ref
    BEV width, stride 1 and 2) equals the exact int32 product."""
    from q3d_tpu_torch.models.layers import INT_MM_CALLS, int8_conv2d
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(-127, 128, (2, 128, 45, 47))
                         .astype(np.int8)).to(card)
    w = torch.from_numpy(rng.randint(-127, 128, (256, 128, 3, 3))
                         .astype(np.int8)).to(card)
    for stride in ((1, 1), (2, 2)):
        calls = INT_MM_CALLS["int8_conv2d"]
        out_k = int8_conv2d(x, w, stride, (1, 1))
        out_p = int8_conv2d(x, w, stride, (1, 1), impl="plain")
        assert INT_MM_CALLS["int8_conv2d"] == calls + 1
        assert out_k.dtype == torch.int32 and torch.equal(out_k, out_p)
        ref = torch.nn.functional.conv2d(x.double().cpu(), w.double().cpu(),
                                         stride=stride, padding=1)
        assert torch.equal(out_p.cpu(), ref.to(torch.int32))


@pytest.mark.parametrize("m,k,n", [(80000, 64, 2), (80000, 576, 14),
                                   (5, 64, 8), (100, 27, 3)])
def test_int8_matmul_pads_to_int_mm_shapes(card, m, k, n):
    """``_int_mm`` takes M > 16 and K, N multiples of 8: an anchor tower's
    1x1 conv_cls (2 outputs), its conv_box (14) and other shapes are padded
    with zeros; the s32 product equals the exact one."""
    from q3d_tpu_torch.models import layers
    g = torch.Generator(device=card).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=card,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=card,
                      dtype=torch.int8)
    calls = layers.INT_MM_CALLS["held"]
    got = layers.int8_matmul(a, b, "cuda", tag="held")
    assert layers.INT_MM_CALLS["held"] == calls + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, layers.int8_matmul(a, b, "plain"))


@pytest.mark.parametrize("k", [1, 65, 128, 200, 1024, 2048, 2049, 4096])
def test_greedy_nms_kernel_matches_plain(card, k):
    """The IoU form, on the sweep it shares with the boxes form: one row
    block, a ragged last block, K = 2048 (32 mask words, one per lane of
    the sweep's second warp), K = 2049 (the first K whose lanes own two
    words) and K = 4096 (all 64 words)."""
    rng = np.random.RandomState(k)
    iou = rng.rand(4, k, k).astype(np.float32) * (rng.rand(4, k, k) < 0.3)
    iou = torch.from_numpy(iou).to(card)
    valid = torch.from_numpy(rng.rand(4, k) > 0.1).to(card)
    for thresh in (0.1, 0.5):
        assert torch.equal(
            port_nms.greedy_nms(iou, valid, thresh),
            port_nms.greedy_nms(iou, valid, thresh, impl="plain"))


@pytest.mark.parametrize("k", [128, 200, 1024, 2049, 4096])
def test_greedy_nms_boxes_kernel_matches_plain(card, k):
    """The boxes form: crowded boxes with identical and rotated duplicates
    and invalid rows.  Keep masks equal the plain version's; the kernel's
    IoU is bit-equal to ``boxes_iou_bev`` at every pair it evaluated, and
    every valid pair j < i that it skipped has a plain IoU of exactly 0."""
    rng = np.random.RandomState(k)
    s = 4 if k <= 2048 else 2       # the plain IoU's (S, K, K, 4, 4) terms
    b = np.zeros((s, k, 7), np.float32)
    b[..., 0:2] = rng.uniform(-12, 12, (s, k, 2))
    b[..., 3:6] = rng.uniform(0.5, 4.0, (s, k, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (s, k))
    b[:, 10:20] = b[:, 0:10]
    b[:, 20:30, :6] = b[:, 30:40, :6]
    boxes = torch.from_numpy(b).to(card)
    valid = torch.from_numpy(rng.rand(s, k) > 0.15).to(card)
    corners, areas = port_nms.bev_corners_areas(boxes)
    iou_p = boxes_iou_bev(boxes, boxes)
    need = valid[:, :, None] & valid[:, None, :] & torch.ones(
        (k, k), dtype=torch.bool, device=card).triu(1)
    for thresh in (0.1, 0.5):
        iou_k = torch.full((s, k, k), float("nan"), device=card)
        launches = port_nms.KERNEL.launches["q3d_greedy_nms_boxes"]
        keep_k = port_nms.greedy_suppress_boxes_cuda(corners, areas, valid,
                                                     thresh, iou_out=iou_k)
        keep_p = port_nms.greedy_nms_boxes(boxes, valid, thresh, impl="plain")
        torch.cuda.synchronize()
        assert port_nms.KERNEL.launches["q3d_greedy_nms_boxes"] \
            == launches + 1
        assert torch.equal(keep_k, keep_p)
        assert torch.equal(keep_k, port_nms.greedy_nms_boxes(boxes, valid,
                                                             thresh))
        done = ~torch.isnan(iou_k)
        assert not (done & ~need).any()
        assert int(done.sum()) > 0
        assert torch.equal(iou_k[done].view(torch.int32),
                           iou_p[done].view(torch.int32))
        assert not (iou_p[need & ~done] != 0).any()


@pytest.mark.parametrize("nms_type", ["nms_gpu", "nms_normal_gpu"])
def test_multi_class_nms_kernels_match_plain(card, nms_type):
    """``multi_classes_nms`` as SECOND-MultiHead runs it: 2 frames of 4,000
    crowded boxes scored for 9 classes, K = NMS_PRE_MAXSIZE = 1024, so 18
    candidate sets in one launch (the boxes form for ``nms_gpu``, the IoU
    form on the axis-aligned IoU for ``nms_normal_gpu``): indices, valid
    flags and scores equal to the plain version's, every survivor kept
    (NMS_POST_MAXSIZE 1024), some suppressed."""
    from q3d_tpu_torch.models.model_utils import model_nms_utils
    rng = np.random.RandomState(13)
    b, n, c = 2, 4000, 9
    x = np.zeros((b, n, 7), np.float32)
    x[..., 0:2] = rng.uniform(-30, 30, (b, n, 2))
    x[..., 3:6] = rng.uniform(0.5, 6.0, (b, n, 3))
    x[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    x[:, 10:20] = x[:, 0:10]
    boxes = torch.from_numpy(x).to(card)
    scores = torch.from_numpy(rng.uniform(0, 1, (b, n, c)).astype(
        np.float32)).to(card)
    cfg = EDict({"NMS_TYPE": nms_type, "NMS_THRESH": 0.2,
                 "NMS_PRE_MAXSIZE": 1024, "NMS_POST_MAXSIZE": 1024})
    entry = "q3d_greedy_nms_boxes" if nms_type == "nms_gpu" \
        else "q3d_greedy_nms"
    port_nms.KERNEL.launches.clear()
    got = model_nms_utils.multi_classes_nms(scores, boxes, cfg, 0.1,
                                            impl="cuda")
    torch.cuda.synchronize()
    assert dict(port_nms.KERNEL.launches) == {entry: 1}
    want = model_nms_utils.multi_classes_nms(scores, boxes, cfg, 0.1,
                                             impl="plain")
    assert got[0].shape == (b, c, 1024)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_tiny_model_kernels_match_plain(card):
    """centerpoint_tiny, seeded random weights, f32 without TF32: the model
    through its kernels equals the model through the plain versions."""
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=card)
    batch = load_data_to_device(next(iter(loader)), device=card)
    conv_launches = sum(gather_conv.KERNEL.launches.values())
    nms_launches = port_nms.KERNEL.launches["q3d_greedy_nms_boxes"]
    with torch.no_grad():
        out_k = model(dict(batch))
        model.set_kernel_impl("plain")
        out_p = model(dict(batch))
        model.set_kernel_impl(None)
    assert sum(gather_conv.KERNEL.launches.values()) - conv_launches == 21
    assert port_nms.KERNEL.launches["q3d_greedy_nms_boxes"] \
        - nms_launches == 1
    for key in ("spatial_features", "spatial_features_2d"):
        torch.testing.assert_close(out_k[key], out_p[key], rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(out_k["final_valid"], out_p["final_valid"])


def test_tiny_transfusion_kernels_match_plain(card):
    """transfusion_tiny, seeded random weights, BN statistics from the
    batch, f32 without TF32: 21 kernel-1 launches and no NMS; the BEV maps,
    the top-50 queries and their detections through the kernels equal the
    plain versions' (maps and boxes within 1e-4, labels and valid flags
    equal)."""
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns
    cfg = cfg_from_yaml_file(str(CFG.parent / "transfusion_tiny.yaml"),
                             EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=card)
    batch = load_data_to_device(next(iter(loader)), device=card)
    calibrate_bns(model, batch)
    conv_launches = sum(gather_conv.KERNEL.launches.values())
    nms_launches = sum(port_nms.KERNEL.launches.values())
    with torch.no_grad():
        out_k = model(dict(batch))
        model.set_kernel_impl("plain")
        out_p = model(dict(batch))
        model.set_kernel_impl(None)
    assert sum(gather_conv.KERNEL.launches.values()) - conv_launches == 21
    assert sum(port_nms.KERNEL.launches.values()) == nms_launches
    for key in ("spatial_features", "spatial_features_2d", "final_boxes",
                "final_scores"):
        torch.testing.assert_close(out_k[key], out_p[key], rtol=1e-4,
                                   atol=1e-4)
    for key in ("final_labels", "final_valid"):
        assert torch.equal(out_k[key], out_p[key]), key


def test_tiny_model_int8_kernels_match_plain(card):
    """centerpoint_tiny under the bench int8 recipe, calibrated on the card:
    through the kernels (the fused s8 entry, ``_int_mm``) and through the
    plain versions, the same int8 features at every residency conv and the
    same detections."""
    from q3d_tpu_torch.models.layers import INT_MM_CALLS
    from q3d_tpu_torch.quant import api as quant_api
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=card)
    batch = load_data_to_device(next(iter(loader)), device=card)
    quant_api.prepare_int8_deploy(model, [batch, batch], recipe_kwargs=dict(
        quantize_first_conv=True, extra_no_list=("dense_head.*",)))
    feats = {}

    def keep(impl):
        def hook(mod, args, out):
            feats.setdefault(impl, []).append(out.features)
        return hook
    convs = [m for m in model.backbone_3d.modules() if hasattr(m, "QUANT_KIND")]
    outs = {}
    for impl in ("cuda", "plain"):
        hooks = [c.register_forward_hook(keep(impl)) for c in convs]
        launches = gather_conv.KERNEL.launches[gather_conv.REQUANT_ENTRY]
        mm_calls = INT_MM_CALLS["int8_conv2d"]
        model.set_kernel_impl(impl)
        with torch.no_grad():
            outs[impl] = model(dict(batch))
        for h in hooks:
            h.remove()
        fused = gather_conv.KERNEL.launches[gather_conv.REQUANT_ENTRY] - launches
        assert fused == (21 if impl == "cuda" else 0)
        assert INT_MM_CALLS["int8_conv2d"] - mm_calls == (6 if impl == "cuda"
                                                          else 0)
    model.set_kernel_impl(None)
    assert len(feats["cuda"]) == len(feats["plain"]) == 21
    for a, b in zip(feats["cuda"], feats["plain"]):
        assert a.dtype == torch.int8 and torch.equal(a, b)
    for key in ("spatial_features", "final_boxes", "final_scores",
                "final_labels", "final_valid"):
        assert torch.equal(outs["cuda"][key], outs["plain"][key]), key


def _sparse_tensor(rng, card, n_cap, n_valid, cin, shape=(20, 64, 64)):
    """A batch-2 sparse tensor with unique random coordinates and padding
    rows, rows sorted by key, on the card."""
    from q3d_tpu_torch.ops.spconv import SparseConvTensor
    cells = int(np.prod(shape))
    flat = rng.choice(2 * cells, n_valid, replace=False)
    b, rest = np.divmod(flat, cells)
    z, rest = np.divmod(rest, shape[1] * shape[2])
    y, x = np.divmod(rest, shape[2])
    idx = np.full((n_cap, 4), -1, np.int32)
    idx[:n_valid] = np.stack([b, z, y, x], 1)
    feats = rng.randn(n_cap, cin).astype(np.float32)
    feats[n_valid:] = 0.0
    return SparseConvTensor(torch.from_numpy(feats).to(card),
                            torch.from_numpy(idx).to(card), shape,
                            2).sort_rows()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["subm", "strided"])
@pytest.mark.parametrize("cin,cout", BACKBONE_WIDTHS)
def test_gather_conv_backward_kernel_matches_plain(card, cin, cout, kind,
                                                   dtype):
    """The conv under autograd through the kernel and through the plain
    version, on the books of a SubM and a strided conv over 6000 of 8000
    rows: dX (kernel 1 over the inverse book, weights transposed per tap)
    and dW (gather + f32 matmul per tap) agree (f32: within 1e-5 of each
    tensor's largest value; bf16: one bf16 rounding); the forward and the
    input gradient each launch the kernel once under the dtype's entry;
    padding rows get a zero gradient; the inverse book equals one built by
    hand."""
    from q3d_tpu_torch.ops.spconv import engine
    rng = np.random.RandomState(cin + 7 * cout + (kind == "subm"))
    st = _sparse_tensor(rng, card, 8000, 6000, cin)
    if kind == "subm":
        book, out_valid = engine.subm_gather_indices(st, 3), None
    else:
        out_idx, book, _ = engine.sparse_conv_downsample(st, 3, 2, 1)
        out_valid = out_idx[:, 0] >= 0
    n, m = st.capacity, book.shape[0]
    inv = engine.inverse_book(book, n).cpu().numpy()
    by_hand = np.full((n, 27), -1, np.int32)
    rows, taps = np.nonzero((book.cpu().numpy() >= 0)
                            & (book.cpu().numpy() < n))
    by_hand[book.cpu().numpy()[rows, taps], taps] = rows
    assert len(np.unique(book.cpu().numpy()[rows, taps] * 27 + taps)) \
        == len(rows)                         # each (n, k) read at most once
    np.testing.assert_array_equal(inv, by_hand)

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    w = torch.from_numpy((rng.randn(27, cin, cout) / np.sqrt(27 * cin))
                         .astype(np.float32)).to(card, dt)
    cot = torch.from_numpy(rng.randn(m, cout).astype(np.float32)).to(card, dt)
    grads = {}
    for impl in ("cuda", "plain"):
        f = st.features.to(dt).detach().requires_grad_(True)
        wt = w.detach().requires_grad_(True)
        entry = f"q3d_sparse_gather_conv_{dtype}"
        before = gather_conv.KERNEL.launches[entry]
        out = gather_conv.sparse_gather_conv(f, book, wt, out_valid=out_valid,
                                             impl=impl)
        fwd = gather_conv.KERNEL.launches[entry] - before
        (out.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        bwd = gather_conv.KERNEL.launches[entry] - before - fwd
        assert (fwd, bwd) == ((1, 1) if impl == "cuda" else (0, 0))
        grads[impl] = (f.grad.float(), wt.grad.float())
    pad = ~st.valid
    for name, a, b in zip(("dX", "dW"), grads["cuda"], grads["plain"]):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        if dtype == "f32":
            assert float((a - b).abs().max()) <= 1e-5 * scale, name
        else:
            torch.testing.assert_close(a, b, rtol=2 ** -7, atol=2e-2 * scale)
    assert not grads["cuda"][0][pad].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 32), (32, 16)])
def test_inverse_conv_kernel_matches_plain(card, cin, cout, dtype):
    """UNetV2's three inverse convs' widths: a strided conv (stride 2, pad
    1) over 6000 of 8000 rows, then ``SparseInverseConv3d`` back onto its
    input's coordinates, through the kernel and through the plain version.
    Its book, the transpose of the strided conv's, equals
    ``engine.inverse_conv_indices``; the output and dX (over the strided
    conv's own book) agree as in ``test_gather_conv_backward_kernel_
    matches_plain``; the forward and dX each launch the kernel once; the
    target's padding rows come out 0."""
    from q3d_tpu_torch.ops.spconv import (SparseConv3d, SparseInverseConv3d,
                                          engine)
    from q3d_tpu_torch.ops.spconv.modules import inverse_cache_key
    rng = np.random.RandomState(cin + 3 * cout)
    target = _sparse_tensor(rng, card, 8000, 6000, 16)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    cache = {}
    strided = SparseConv3d(16, cin, 3, 2, 1)
    inv = SparseInverseConv3d(cin, cout, 3, 2, 1)
    gen = torch.Generator().manual_seed(cin + cout)
    strided.reset_parameters(gen)
    inv.reset_parameters(gen)
    strided, inv = strided.to(card), inv.to(card)
    with torch.no_grad():
        x = strided(target, cache)
    feats = torch.from_numpy(rng.randn(x.capacity, cin).astype(np.float32)
                             ).to(card, dt) * x.valid[:, None]
    cot = torch.from_numpy(rng.randn(target.capacity, cout)
                           .astype(np.float32)).to(card, dt)
    runs = {}
    for impl in ("cuda", "plain"):
        inv.kernel_impl = impl
        f = feats.detach().requires_grad_(True)
        entry = f"q3d_sparse_gather_conv_{dtype}"
        before = gather_conv.KERNEL.launches[entry]
        out = inv(x.replace(features=f), target, cache)
        fwd = gather_conv.KERNEL.launches[entry] - before
        (out.features.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        bwd = gather_conv.KERNEL.launches[entry] - before - fwd
        assert (fwd, bwd) == ((1, 1) if impl == "cuda" else (0, 0))
        runs[impl] = (out.features.detach().float(), f.grad.float())
    book, back = cache[inverse_cache_key(target.spatial_shape,
                                         inv.kernel_size, 2, 1)]
    assert back is not None
    assert torch.equal(book, engine.inverse_conv_indices(
        x, target.indices, 3, 2, 1))
    for name, a, b in zip(("out", "dX"), runs["cuda"], runs["plain"]):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0, name
        if dtype == "f32":
            assert float((a - b).abs().max()) <= 1e-5 * scale, name
        else:
            torch.testing.assert_close(a, b, rtol=2 ** -7, atol=2e-2 * scale)
    assert not runs["cuda"][0][~target.valid].any()


@pytest.mark.parametrize("kind", ["subm", "stride1"])
def test_gather_conv_backward_2d_books_match_plain(card, kind):
    """VoxelNeXt's 2D convs under autograd (f32, 128 -> 128, K = 9, over
    960,000 rows of which 40,000 are valid): the SubMConv2d book and the
    stride-1 SparseConv2d book (its outputs the dilation of its inputs).
    dX through the kernel (one launch of the f32 entry over the 2D inverse
    book, weights transposed per tap) and through the plain version agree
    within 1e-5 of the largest |dX|, dW within 1e-5 of the largest |dW|;
    the inverse book equals one built by hand (each (row, tap) read at
    most once); padding rows get a zero gradient."""
    from q3d_tpu_torch.ops.spconv import engine
    rng = np.random.RandomState(31 + len(kind))
    st = _bev_tensor(rng, card, 960_000, 40_000, 128)
    if kind == "subm":
        book, out_valid = engine.subm_gather_indices(st, 3), None
    else:
        out_idx, book, _ = engine.sparse_conv_downsample(st, 3, 1, 1)
        out_valid = out_idx[:, 0] >= 0
    n, m = st.capacity, book.shape[0]
    assert book.shape[1] == 9
    b_np = book.cpu().numpy()
    rows, taps = np.nonzero((b_np >= 0) & (b_np < n))
    assert len(np.unique(b_np[rows, taps] * 9 + taps)) == len(rows)
    by_hand = np.full((n, 9), -1, np.int32)
    by_hand[b_np[rows, taps], taps] = rows
    np.testing.assert_array_equal(engine.inverse_book(book, n).cpu().numpy(),
                                  by_hand)
    w = torch.from_numpy((rng.randn(9, 128, 128) / np.sqrt(9 * 128))
                         .astype(np.float32)).to(card)
    cot = torch.from_numpy(rng.randn(m, 128).astype(np.float32)).to(card)
    grads = {}
    for impl in ("cuda", "plain"):
        f = st.features.detach().requires_grad_(True)
        wt = w.detach().requires_grad_(True)
        before = gather_conv.KERNEL.launches["q3d_sparse_gather_conv_f32"]
        out = gather_conv.sparse_gather_conv(f, book, wt, out_valid=out_valid,
                                             impl=impl)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        launched = gather_conv.KERNEL.launches["q3d_sparse_gather_conv_f32"] \
            - before
        assert launched == (2 if impl == "cuda" else 0)
        grads[impl] = (f.grad, wt.grad)
    for name, a, b in zip(("dX", "dW"), grads["cuda"], grads["plain"]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name
    assert not grads["cuda"][0][~st.valid].any()


# the pillar backbone's widths at 256 channels (PillarRes18BackBone8x's
# conv4 stage: the strided 128 -> 256 conv, the SubM 256 -> 256 convs and
# the strided conv's input gradient, 256 -> 128) and the narrowest pairs
# with a 256-wide side; K = 9, the 2D books' taps
WIDE_WIDTHS = [(128, 256), (256, 256), (256, 128), (16, 256), (256, 16)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "s8"])
@pytest.mark.parametrize("cin,cout", WIDE_WIDTHS)
def test_gather_conv_256_kernel_matches_plain(card, cin, cout, dtype):
    """Cout = 256 runs as two 128-column tiles of the grid, Cin = 256 as
    more steps a tap: the same cases as at the narrower widths."""
    test_gather_conv_kernel_matches_plain(card, cin, cout, 9, dtype)


@pytest.mark.parametrize("identity", ["none", "s8", "f32"])
@pytest.mark.parametrize("cin,cout", WIDE_WIDTHS)
def test_gather_conv_requant_256_kernel_matches_plain(card, cin, cout,
                                                      identity):
    """The fused s8 entry at 256 channels, bit for bit: the BN fold, the
    identity and the row mask read at each tile's own columns."""
    test_gather_conv_requant_kernel_matches_plain(card, cin, cout, 9,
                                                  identity)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["subm", "strided"])
@pytest.mark.parametrize("cin,cout", [(128, 256), (256, 256)])
def test_gather_conv_backward_256_kernel_matches_plain(card, cin, cout, kind,
                                                       dtype):
    """dX and dW at 256 channels (dX of a 128 -> 256 conv is kernel 1 at
    256 -> 128 over the inverse book)."""
    test_gather_conv_backward_kernel_matches_plain(card, cin, cout, kind,
                                                   dtype)


def _kitti_like_points(rng, frames, n, valid_rows):
    """KITTI-sized point sets: ``valid_rows`` points a frame in the FOV
    crop's extent (0-70 m ahead, +-35 m, -3-1 m), zero padding past them."""
    xyz = np.zeros((frames, n, 3), np.float32)
    valid = np.zeros((frames, n), bool)
    for f, m in enumerate(valid_rows):
        xyz[f, :m] = rng.uniform((0, -35, -3), (70, 35, 1), (m, 3))
        valid[f, :m] = True
    return xyz, valid


def test_farthest_point_sample_on_the_card_equals_cpu(card):
    """PV-RCNN's keypoint sampling at KITTI size: 2048 picks from 2 x 30,000
    padded points (24,641 and 22,091 valid), on the card and on the CPU:
    the indices equal (distances summed x, y, z in order in both, the
    first of equal distances picked)."""
    xyz, valid = _kitti_like_points(np.random.RandomState(0), 2, 30000,
                                    (24641, 22091))
    got = farthest_point_sample(torch.from_numpy(xyz).to(card), 2048,
                                torch.from_numpy(valid).to(card))
    want = farthest_point_sample(torch.from_numpy(xyz), 2048,
                                 torch.from_numpy(valid))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("centres,radius,nsample", [(2048, 0.8, 16),
                                                     (2048, 4.8, 32),
                                                     (21600, 1.6, 16)])
def test_ball_query_on_the_card_equals_cpu(card, centres, radius, nsample):
    """The chunked ball query at KITTI size: 2 frames x 40,000 rows (a
    stage's cap; 21,260 and 20,540 valid), the VSA's 2048 keypoints or a
    Voxel R-CNN forward's 100 rois x 216 grid points, on the card and on
    the CPU: indices and masks equal."""
    rng = np.random.RandomState(centres + nsample)
    xyz, valid = _kitti_like_points(rng, 2, 40000, (21260, 20540))
    pick = rng.randint(0, 20540, (2, centres))
    new_xyz = np.take_along_axis(xyz, pick[..., None], axis=1) \
        + rng.uniform(-0.5, 0.5, (2, centres, 3)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xyz, new_xyz, valid)]
    got = ball_query(radius, nsample, *(a.to(card) for a in args[:2]),
                     args[2].to(card))
    want = ball_query(radius, nsample, *args)
    assert torch.equal(got[1].cpu(), want[1]) and bool(want[1].any())
    assert torch.equal(got[0].cpu(), want[0])


def test_tiny_pvrcnn_kernels_match_plain(card):
    """pvrcnn_tiny in f32 on the card through the kernels and through the
    plain versions: 12 kernel-1 launches and one kernel-2 launch (the
    proposal layer's 2 sets) through the kernels, none through the plain
    versions; the rois and the final outputs within 1e-4."""
    cfg = cfg_from_yaml_file(str(CFG.parent / "pvrcnn_tiny.yaml"), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=card)
    batch = load_data_to_device(next(iter(loader)), device=card)
    outs, launches = {}, {}
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            gather_conv.KERNEL.launches.clear()
            port_nms.KERNEL.launches.clear()
            model.set_kernel_impl(impl)
            outs[impl] = model(dict(batch))
            torch.cuda.synchronize()
            launches[impl] = (sum(gather_conv.KERNEL.launches.values()),
                              port_nms.KERNEL.launches[
                                  "q3d_greedy_nms_boxes"])
    assert launches == {"cuda": (12, 1), "plain": (0, 0)}
    for key in ("rois", "final_boxes", "final_scores"):
        assert torch.allclose(outs["cuda"][key], outs["plain"][key],
                              rtol=0, atol=1e-4), key
    for key in ("roi_valid", "final_valid", "final_labels"):
        assert torch.equal(outs["cuda"][key], outs["plain"][key]), key


@pytest.mark.parametrize("k", [4097, 6000, 9000])
def test_greedy_nms_wide_kernels_match_plain(card, k):
    """The widest instance (65 to 144 mask words a row; three staged row
    blocks in the sweep; kernel B on 1024 blocks a set): both entries on
    crowded boxes with duplicates and one degenerate quad
    (``nms_ab.crowded_with_degenerate``), at thresh 0.8
    (the training proposal layer's) and 0.3; the boxes form from the boxes,
    the IoU form from their needed pairs' IoU.  Each keep mask bit-equal to
    the plain version's."""
    from q3d_tpu_torch.tools.nms_ab import crowded_with_degenerate
    boxes, valid = crowded_with_degenerate(np.random.RandomState(k), 2, k,
                                           card)
    iou = port_nms.needed_pair_iou(boxes, valid)
    corners = port_nms.bev_corners_areas(boxes)[0]
    # the degenerate quad's short edges: corners within an ulp or two
    assert float((corners[:, 50, 0] - corners[:, 50, 1]).abs().max()) < 4e-6
    for thresh in (0.8, 0.3):
        want = port_nms.greedy_suppress_plain(iou, valid, thresh)
        assert torch.equal(want, port_nms.greedy_nms_boxes(
            boxes, valid, thresh, impl="plain"))
        assert torch.equal(port_nms.greedy_nms_boxes(boxes, valid, thresh),
                           want)
        assert torch.equal(port_nms.greedy_nms(iou, valid, thresh), want)
        assert 0 < int(want.sum()) < int(valid.sum())


def test_greedy_nms_wrappers_raise_above_max_k(card):
    """Past MAX_K = 9216 both wrappers raise on CUDA tensors, and so do the
    C entries if asked directly (cudaErrorInvalidValue, nothing launched)."""
    k = port_nms.MAX_K + 1
    valid = torch.ones((1, k), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match=r"K must be in \[1, 9216\]"):
        port_nms.greedy_suppress_boxes_cuda(
            torch.zeros((1, k, 4, 2), device=card),
            torch.ones((1, k), device=card), valid, 0.5)
    with pytest.raises(ValueError, match=r"K must be in \[1, 9216\]"):
        port_nms.greedy_suppress_cuda(torch.empty((1, k, k), device=card),
                                      valid, 0.5)
    keep = torch.empty((1, k), dtype=torch.bool, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="error 1"):
        port_nms.KERNEL.call(
            "q3d_greedy_nms_boxes", 0, 0, valid.data_ptr(), 0,
            keep.data_ptr(), None, 1, k, 0.5, stream)
    with pytest.raises(RuntimeError, match="error 1"):
        port_nms.KERNEL.call("q3d_greedy_nms", 0, valid.data_ptr(), 0,
                             keep.data_ptr(), 1, k, 0.5, stream)


def test_greedy_nms_boxes_evaluates_degenerate_quads(card):
    """A pair 56 m apart, one of whose quads has corners rounded onto each
    other (a seeded PV-RCNN's proposals): the plain formula gives it an IoU
    of 8.3e-5, so at thresh 0 the second box is suppressed.  The kernel's
    circle test gives the degenerate quad an infinite radius, so it
    evaluates the pair: keep masks equal and the IoU bit-equal."""
    corners = torch.tensor([[
        [[80.71006774902344, 33.170570373535156],
         [70.947998046875, -17.62371253967285],
         [70.94821166992188, -17.623754501342773],
         [80.71028137207031, 33.1705322265625]],
        [[30.93077850341797, 65.24694061279297],
         [54.57554626464844, 41.308204650878906],
         [54.57554626464844, 41.308204650878906],
         [30.9307804107666, 65.24694061279297]]]], device=card)
    areas = torch.tensor([[0.011400755494832993, 6.532079714816064e-05]],
                         device=card)
    valid = torch.ones((1, 2), dtype=torch.bool, device=card)
    iou_k = torch.full((1, 2, 2), float("nan"), device=card)
    keep = port_nms.greedy_suppress_boxes_cuda(corners, areas, valid, 0.0,
                                               iou_out=iou_k)
    overlap = iou3d_nms_utils._rotated_overlap_quads(corners[0, 0],
                                                     corners[0, 1])
    iou_p = overlap / (areas[0, 0] + areas[0, 1] - overlap).clamp(min=1e-6)
    assert float(iou_p) > 0
    assert iou_k[0, 0, 1].view(torch.int32) == iou_p.view(torch.int32)
    assert keep.tolist() == [[True, False]]


def test_kitti_eval_overlaps_on_the_card_equal_cpu(card):
    """The KITTI evaluator's rotated overlaps (``kitti_eval.frame_overlaps``:
    the port's ``boxes_iou_bev`` / ``boxes_iou3d`` on the device it is
    given) on the card within 1e-6 of the CPU's, on camera-frame annos of
    jittered boxes near each other (pairs that overlap and pairs that do
    not)."""
    from q3d_tpu_torch.datasets.kitti import kitti_eval
    rng = np.random.RandomState(0)
    gts, dts = [], []
    for n, m in ((12, 30), (1, 7), (25, 25)):
        loc = np.c_[rng.uniform(-10, 10, n), rng.uniform(0.5, 2, n),
                    rng.uniform(5, 40, n)]
        dims = rng.uniform([1, 1, 0.5], [5, 2, 2], (n, 3))
        ry = rng.uniform(-np.pi, np.pi, n)
        pick = rng.randint(0, n, m)
        gts.append({"location": loc, "dimensions": dims, "rotation_y": ry})
        dts.append({"location": loc[pick] + rng.normal(0, 0.4, (m, 3)),
                    "dimensions": dims[pick] * rng.uniform(0.8, 1.2, (m, 3)),
                    "rotation_y": ry[pick] + rng.normal(0, 0.2, m)})
    for metric in (1, 2):
        on_card = kitti_eval.frame_overlaps(gts, dts, metric, device=card)
        on_cpu = kitti_eval.frame_overlaps(gts, dts, metric, device="cpu")
        for a, b in zip(on_card, on_cpu):
            assert a.shape == b.shape and (b > 0.3).sum() > 0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
