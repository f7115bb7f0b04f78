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
