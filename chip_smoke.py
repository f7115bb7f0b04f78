#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``q3d_tpu_torch``) end to end on one card.

    python3 chip_smoke.py

Phases, one JSON line each (plus the card line from nvidia-smi):
  1. card     — name/power limit (nvidia-smi) and the torch / CUDA versions;
  2. build    — nvcc builds the kernels from ``q3d_tpu_torch/csrc`` (one
                process per source, started together);
  3. kernels  — each CUDA kernel held against its plain PyTorch version at
                the main path's real shapes: the sparse gather-conv on the
                rulebooks of all 21 backbone convs of the first
                centerpoint_ref batch-2 request (f32 and bf16 within stated
                tolerances, s8 with out_scale/out_valid bit-exact), per
                conv and summed per (Cin, Cout, K) group; greedy NMS in
                both forms: the IoU form's keep masks exactly equal on that
                request's 6 IoU matrices and on random K = 128 / 1024 /
                2048 ones; the boxes form's keep masks exactly equal on
                that request's 6 candidate sets and on random crowded boxes
                (K = 128 / 1024, thresh 0.2 / 0.5 / 0.9), its IoU bit-equal
                to boxes_iou_bev at every pair it evaluated and the plain
                IoU exactly 0 at every needed pair it skipped.  Median
                CUDA-event times of each kernel, its plain version and the
                nearest library call; for NMS also candidate_iou (the old
                path's IoU matrix) and each bound's bytes, operations and
                latency terms;
  4. serving  — CenterPoint at centerpoint_ref (full width, seeded random
                weights, BN statistics calibrated on the first request),
                batch 2, bf16 inputs, 4 requests covering the dataset's 8
                frames; per request the host time (scene + voxelize) and
                the device forward, and the valid detections.  Kernel
                launch counts are zeroed just before and read just after;
  5. stages   — CUDA-event time of each stage of one bf16 forward (VFE,
                sparse backbone, BEV map, 2D backbone, head convs, decode +
                NMS, and the head's decode and NMS apart), median of 5;
  6. model    — one request in f32 with TF32 off and cuDNN deterministic
                (as in phase 3 and the BN calibration; the timed bf16
                phases 4-5 run with PyTorch's own settings), through the
                kernels and through the plain versions: BEV maps, every
                head map and the final detections compared; NMS keep masks
                (both forms) and the head's final detections on identical
                candidates must be equal;
  7. int8    — the int8 deploy path under the JAX package's bench recipe
                (every sparse and BEV conv int8 with residency, the head
                bf16), calibrated (method "max") on the first request:
                ``kernel_conv_s8_requant``: each of the 21 residency convs'
                fused s8 entry on its real int8 input and book, bit-equal
                to its plain version, timed beside the unfused s8 entry +
                torch epilogue, the plain version, gather + ``_int_mm``
                and its bound; ``int8_conv2d``: each of the 12 BEV convs'
                ``_int_mm`` s32 equal to the exact product, timed beside
                cuDNN's bf16 conv; ``serving_int8``: 4 requests (launch
                counts zeroed before, read after: 84 fused, 48 ``_int_mm``)
                and bf16 / int8 forwards in turns; ``stages_int8``: the
                stage split of both; ``forward_trace``: device operations
                per forward and the card's busy and idle share, bf16 and
                int8 (torch.profiler); ``model_int8``: bench and entry recipes,
                one request through the kernels and the plain versions:
                every int8 map, spatial_features and detections equal;
  8. eval_gates / eval_plain — the four gates of
                tests/test_accuracy_regression.py on the card: the trained
                centerpoint_tiny fixture (read without JAX), 16 test frames
                at batch 2, f32 with TF32 off; fp32, int8 deploy (full and
                head float), dynamic SmoothQuant and static entropy,
                calibrated as the test does, each through ``eval_one_epoch``
                on the kernels (launch counts zeroed before, read after;
                both kernels must have launched) and on the plain versions
                (no launch): NDS, mAP, relative drop, infer_time_ms; fp32
                NDS > 0.4 and mAP > 0.3, drops <= 1% / 1% / 2% / 3%; the
                per-frame detections of the two runs compared (int8: equal;
                fp32 and fake-quant: as sets, see FQ_*);
  9. fakequant_ref — centerpoint_ref under dynamic SmoothQuant and static
                entropy (calibrated on the first request), f32, one forward
                through the kernels and the plain versions: every map and
                the detections compared; forward and stage times; the 12
                BEV SmoothQuant convs (im2col + fake-quant + matmul) beside
                cuDNN's bf16 conv;
 10. deploy_int8 / kernel_conv_s8 — centerpoint_ref under the int8 deploy
                recipes without residency: ``int8_deploy_recipe()``
                (dynamic), ``(sq=True)`` and ``(static=True)`` (calibrated
                on the first request given twice, entropy amax): launches of
                one forward per entry, held to the recipe's layer counts;
                kernels vs plain on the f32 request (every int8 map,
                spatial_features and the detections equal); int8 and bf16
                forwards in turns; device operations (``forward_trace``).
                Then kernel 1's unfused s8 entry on the dynamic recipe's
                real inputs, bit-equal to plain, beside its plain version,
                gather + ``_int_mm`` and its bound;
 11. driver_tiny — the port's PTQ driver on the trained tiny fixture with
                ``--deploy_int8`` and ``--deploy_int8 --no_sq``: fp32 NDS
                equal to eval_gates', the quantized scores within the JAX
                package's bound (mean |fp - q| < 0.05), NDS / mAP / drop;
                eval_plain also names the first layer where a float run
                differs between kernels and plain versions;
 12. SECOND and PointPillars at KITTI width — each KITTI config's MODEL
                as written (tools/cfgs/kitti_models/), on SyntheticDataset
                scenes at the config's own geometry (range, voxel size,
                points per voxel, the 40,000-voxel test cap; ~120,000
                points a sweep, cropped to the front camera's FOV as the
                dataset yaml's FOV_POINTS_ONLY asks): ``data_<model>``
                (points, voxels and labelled objects per frame; the cap
                must not bind), ``serving_<model>`` (4 bf16 requests of batch 2,
                seeded weights, conv_cls's prior bias 0, BN calibrated on
                the first request; launches: SECOND 48 kernel-1 and 4
                boxes-form NMS launches at K = 4096, PointPillars 0 and 4),
                ``stages_<model>``, ``model_<model>`` (the f32 request
                through the kernels and the plain versions: maps, keep
                masks on identical candidates, detections); then
                ``kernel_conv`` on SECOND's 12 convs, ``kernel_nms`` at K =
                2049 / 4096 (random IoU matrices and crowded boxes at
                thresh 0.01 / 0.5, both models' real candidate sets, times
                and bounds at K = 4096 with every candidate valid, with the
                validity conv_cls's prior bias gives and with the first 512
                valid) and ``recipes_kitti`` (SECOND under
                ``second_recipe()``, PointPillars under
                ``pointpillar_recipe()``, SECOND under
                ``int8_deploy_recipe()``: kernels vs plain);
 13. training (``q3d_tpu_torch.train_utils``), f32:
                ``train_grad`` (centerpoint_ref, batch 2, seeded weights,
                TF32 off: one training forward and backward through the
                kernels and through the plain versions on the first
                request: loss within 1e-5 relative, every gradient within
                1e-4 of its tensor's largest |g|, BN statistics within
                1e-5; kernel 1 launched 21 times forward and 20 times as
                the input gradient; peak memory), ``kernel_dx`` (each of
                those 20 input gradients: kernel 1 over the inverse book
                against its plain version, within 1e-5 of the largest |dX|,
                timed beside it, gather + ``torch.matmul``, the bound, the
                weight gradient's torch time and the inverse book's
                build), ``qat_tiny`` (the trained tiny fixture under
                ``centerpoint_recipe()``, 4 QAT steps; the first through
                the kernels and the plain versions, held as the CPU test
                holds QAT), ``train_tiny`` (8 Adam steps from the seeded
                init on one batch: the loss falls by at least 10%) and
                ``train_ref`` (``train_model`` at ref width, 2 epochs of
                the 8 frames, centerpoint_tiny's OPTIMIZATION; per step
                host ms, forward / backward / optimizer device ms, dX
                kernel and dW ms, peak memory; launches counted over the
                run; resumed from its checkpoint into a fresh model, whose
                model and optimizer state must equal the trained ones);
 14. SECOND and PointPillars training at the KITTI configs' width
                (``kitti_synthetic.kitti_config``: training frames at each
                yaml's geometry, FOV-cropped, the 16,000-voxel train cap,
                batch 4 as BATCH_SIZE_PER_GPU): ``train_kitti_grad`` (one
                batch without augmentation, f32, TF32 off: one step through
                the kernels and through the plain versions at
                ``TRAIN_TOL``; SECOND 12 kernel-1 launches forward and 11 as
                dX, PointPillars none), ``train_overfit`` (8 Adam steps of
                each seeded model on that batch: the last loss below 0.9 x
                the first), ``kernel_fwd_second`` / ``kernel_dx_second``
                (SECOND's 12 conv forwards and 11 input gradients of that
                step, each held against its plain version and timed beside
                it, gather + ``torch.matmul`` and its bound),
                ``qat_kitti`` (one step under ``second_recipe()`` /
                ``pointpillar_recipe()``, each launch held on its own
                operands and the whole step at ``QAT_TOL``) and
                ``train_kitti`` (``train_model``, 8 frames, 2 epochs, each
                yaml's OPTIMIZATION and its whole
                DATA_AUGMENTOR, gt_sampling reading a database written to a
                temporary directory from frames of another seed: per step
                host / forward / backward / optimizer ms and peak memory,
                objects placed per frame, positive anchors per class per
                frame; launches: SECOND 23 a step, PointPillars none, no
                NMS);
 15. the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises and exits nonzero without the last line.  Without
CUDA, or outside a checkout of the repo, it exits 1 and prints no result.
``USE_APPROX_TOPK`` in the config is ignored: the port's top-K is exact.
"""

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_ref.yaml"
BATCH = 2
REQUESTS = 4
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "s8": 1979e12}
# f32 operations of one rotated BEV IoU and of one circle test, counted from
# the formula in q3d_tpu_torch/csrc/greedy_nms.cu
IOU_OPS, IOU_CIRCLE_OPS = 821, 8
# the int8 recipe the JAX package's bench times (bench.py:281)
BENCH_RECIPE = dict(quantize_first_conv=True, extra_no_list=("dense_head.*",))
# the accuracy gates: tests/test_accuracy_regression.py's trained fixture
TINY_CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_tiny.yaml"
CKPT = ROOT / "tests" / "fixtures" / "centerpoint_tiny_trained.pkl"
# recipe -> the largest relative NDS drop against fp32 it may show
GATES = {"fp32": None, "int8_full": 0.01, "int8_head_bf16": 0.01,
         "sq_dynamic": 0.02, "static_entropy": 0.03}
# float fake-quant: kernel and plain versions sum in another order, which
# moves the odd value across a rounding boundary of the next fake-quant (one
# step of 1/127 of its amax), and a flipped rounding can move a detection
# near a decision (the score threshold, an NMS overlap) in or out; the
# detections are held as sets: at least FQ_MATCH_SHARE of those scoring at
# least FQ_MIN_SCORE have a partner of the same frame and label within
# FQ_BOX_TOL (m) and FQ_SCORE_TOL, the valid counts differ by at most
# FQ_COUNT_SHARE of the larger, and the NDS by at most FQ_NDS_TOL
FQ_MIN_SCORE, FQ_BOX_TOL, FQ_SCORE_TOL = 0.15, 0.1, 0.02
FQ_MATCH_SHARE, FQ_COUNT_SHARE, FQ_NDS_TOL = 0.99, 0.05, 1e-3
# fake-quant at centerpoint_ref: each map, kernels vs plain, within this
# share of max(1, its largest magnitude) (flipped roundings, one step each)
FQ_MAP_RTOL = 5e-2
CONV_DESIGN = ("128-row x all-Cout tiles; book loaded once, ballot tap masks; "
               "16-byte cp.async gathers into a 2-3 stage ring; mma.sync "
               "m16n8k16 bf16 / m16n8k32 s8 (f32 on CUDA cores)")

# per forward: kernel 1's launches (SECOND's 12 sparse convs; PointPillars
# has none) and the sparse convs under int8_deploy_recipe() (conv_input
# stays float)
KITTI_CONVS = {"second": 12, "pointpillar": 0}
# the least voxels (pillars) a frame keeps, by model
KITTI_MIN_VOXELS = {"second": 16000, "pointpillar": 9000}
# the KITTI phases' maps, kernels vs plain, in f32 (TF32 off): kernel 1's
# f32 entry sums in the plain order at these widths, so the maps agree to
# rounding, under the fake-quant recipes too (a flipped fake-quant rounding
# would be 1/127 of the scale)
KITTI_MAP_RTOL = 1e-4
# kernel 2 past 32 mask words a row: the first such K, and the largest
WIDE_K = (2049, 4096)


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=10, flush=None):
    """Median CUDA-event time of ``fn`` in ms; ``flush`` (run outside the
    timed region before each rep) evicts the 50 MB L2.  A ~100 us spin
    kernel ahead of the first event keeps the card busy while the host
    enqueues ``fn``, so that a short launch is timed on the device and not
    by the host's Python around it."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_us(fn, names, flush, reps=10):
    """Mean device time in us of each CUDA kernel whose name contains one of
    ``names``, per call of ``fn`` (torch.profiler; L2 flushed before each
    call) -> {name: us}, or "not measured" if the trace has no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        for n in names:
            if n in ev.key and us > 0:
                out[n] = out.get(n, 0.0) + us / reps
    return out or "not measured"


def forward_trace(model, batch, reps=3):
    """Device operations (kernels, copies, fills) per forward of ``model``
    on ``batch``, the card's busy time per forward (their summed device
    time; one stream, so they do not overlap) against the host clock around
    the forwards, the idle share, and the ten operations with the most
    device time -> dict, or "not measured" if the trace has no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(dict(batch))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(dict(batch))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0.0) > 0]
    if not evs:
        return "not measured"
    busy_ms = sum(e.device_time_total for e in evs) / 1e3 / reps
    top = sorted(evs, key=lambda e: -e.device_time_total)[:10]
    return {"device_ops": sum(e.count for e in evs) / reps,
            "device_busy_ms": busy_ms, "traced_forward_ms": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top_ops": [{"op": e.key[:120], "per_forward": e.count / reps,
                         "ms": e.device_time_total / 1e3 / reps}
                        for e in top]}


def stage_times(model, batch, reps=5):
    """CUDA-event time of each stage of one forward of ``model`` on
    ``batch``, median of ``reps`` -> {stage: ms}.  Decode and NMS are
    methods, not modules (CenterHead's ``_decode`` / ``_nms``; an anchor
    head's ``generate_predicted_boxes`` and the detector's
    ``post_processing``), so they are timed through instance attributes
    that shadow them for the run."""
    import torch
    head = model.dense_head
    stages = {"vfe": model.vfe}
    if hasattr(model, "backbone_3d"):
        stages["backbone_3d"] = model.backbone_3d
    stages.update(map_to_bev=model.map_to_bev_module,
                  backbone_2d=model.backbone_2d)
    if hasattr(head, "heads_list"):                 # CenterHead
        stages["head_convs"] = [head.shared_conv, head.shared_requant,
                                *head.heads_list]
        methods = ((head, "_decode", "decode"), (head, "_nms", "nms"))
    else:                                           # AnchorHeadSingle
        stages["head_convs"] = [c for c in (head.conv_cls, head.conv_box,
                                            head.conv_dir_cls) if c is not None]
        methods = ((head, "generate_predicted_boxes", "decode"),
                   (model, "post_processing", "nms"))
    stages["dense_head"] = head
    events = {name: [] for name in (*stages, "decode", "nms")}

    def mark(name, at):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append((at, ev))
        return hook
    hooks = []
    for name, mods in stages.items():
        for mod in (mods if isinstance(mods, list) else [mods]):
            hooks += [mod.register_forward_pre_hook(mark(name, 0)),
                      mod.register_forward_hook(mark(name, 1))]

    def timed(name, fn):
        def run(*args):
            mark(name, 0)()
            out = fn(*args)
            mark(name, 1)()
            return out
        return run
    for owner, attr, name in methods:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    stage_ms = {name: [] for name in events}
    try:
        with torch.no_grad():
            for _ in range(reps):
                for evs in events.values():
                    evs.clear()
                model(dict(batch))
                torch.cuda.synchronize()
                for name, evs in events.items():
                    starts = [e for at, e in evs if at == 0]
                    ends = [e for at, e in evs if at == 1]
                    stage_ms[name].append(sum(a.elapsed_time(b)
                                              for a, b in zip(starts, ends)))
    finally:
        for h in hooks:
            h.remove()
        for owner, attr, _ in methods:
            delattr(owner, attr)
    stage_ms = {k: statistics.median(v) for k, v in stage_ms.items()}
    # CenterHead decodes and runs NMS inside the head; an anchor detector
    # decodes in the head and runs NMS after it
    stage_ms["decode_nms"] = stage_ms["dense_head"] - stage_ms["head_convs"] \
        if hasattr(head, "heads_list") else stage_ms["decode"] + stage_ms["nms"]
    return stage_ms


def plain_scene(ds, j):
    """Frame ``j`` of the synthetic dataset ``ds`` as its ``__getitem__``
    makes it -> (points, gt_boxes, gt_names)."""
    import numpy as np
    from q3d_tpu_torch.datasets.synthetic_dataset import make_scene
    return make_scene(np.random.RandomState(ds.base_seed + j),
                      ds.point_cloud_range, **ds.scene_kwargs)


def make_request(ds, r, scene=plain_scene):
    """Frames BATCH*r ... BATCH*r + BATCH-1 of the synthetic dataset ``ds``,
    each from ``scene(ds, j)`` -> (numpy batch, scene ms, voxelize ms):
    host time, scene synthesis and the data pipeline apart."""
    frames, scene_ms, vox_ms = [], 0.0, 0.0
    for j in range(r * BATCH, (r + 1) * BATCH):
        t0 = time.perf_counter()
        points, boxes, names = scene(ds, j)[:3]
        t1 = time.perf_counter()
        frames.append(ds.prepare_data({"points": points, "gt_boxes": boxes,
                                       "gt_names": names, "frame_id": j}))
        t2 = time.perf_counter()
        scene_ms += (t1 - t0) * 1e3
        vox_ms += (t2 - t1) * 1e3
    return ds.collate_batch(frames), scene_ms, vox_ms


def check_boxes_form(boxes, valid, th, what):
    """The boxes form against its plain version (boxes_iou_bev, then the
    plain sweep): keep masks equal; the kernel's IoU bit-equal at every
    pair it evaluated; every needed pair (j < i, both valid) it skipped
    has a plain IoU of exactly 0.  -> (pairs evaluated, pairs needed,
    the most pairs evaluated in one 64 x 64 tile)."""
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import boxes_iou_bev
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    dev = boxes.device
    s_, k_ = valid.shape
    corners, areas = nms_mod.bev_corners_areas(boxes)
    iou_k = torch.full((s_, k_, k_), float("nan"), device=dev)
    keep_k = nms_mod.greedy_suppress_boxes_cuda(corners, areas, valid, th,
                                                iou_out=iou_k)
    iou_p = boxes_iou_bev(boxes[..., :7], boxes[..., :7])
    keep_p = nms_mod.greedy_suppress_plain(iou_p, valid, th)
    diff = (keep_k != keep_p).nonzero()
    check(len(diff) == 0, f"greedy_nms_boxes {what} thresh={th}: "
                          f"{len(diff)} keep flags differ, first (set, "
                          f"row) {diff[:1].tolist()}")
    need = valid[:, :, None] & valid[:, None, :] & torch.ones(
        (k_, k_), dtype=torch.bool, device=dev).triu(1)
    done = ~torch.isnan(iou_k)
    stray = (done & ~need).nonzero()
    check(len(stray) == 0, f"greedy_nms_boxes {what}: evaluated pairs "
                           f"outside j < i, both valid: {stray[:3].tolist()}")
    for bad, why in (
            (done & (iou_k.view(torch.int32) != iou_p.view(torch.int32)),
             "kernel IoU != plain IoU"),
            (need & ~done & (iou_p != 0), "skipped pair has plain IoU != 0")):
        at = bad.nonzero()
        if len(at):
            s0, j0, i0 = at[0].tolist()
            check(False, f"greedy_nms_boxes {what} thresh={th}: {len(at)} "
                         f"pairs: {why}; first set {s0} (j={j0}, i={i0}): "
                         f"kernel {float(iou_k[s0, j0, i0])!r}, plain "
                         f"{float(iou_p[s0, j0, i0])!r}")
    kt = -(-k_ // 64)
    tiles = torch.nn.functional.pad(
        done, (0, 64 * kt - k_, 0, 64 * kt - k_)).reshape(
        s_, kt, 64, kt, 64).sum((2, 4))
    return int(done.sum()), int(need.sum()), int(tiles.max())



def record_sparse_convs(model, batch):
    """One forward of ``model`` on ``batch`` with every sparse conv call
    recorded in order -> ([(name, features, book, weight, row mask)], the
    forward's outputs)."""
    import torch
    from q3d_tpu_torch.ops.spconv.modules import (SubMConv3d, SparseConv3d,
                                                  subm_cache_key,
                                                  down_cache_key)
    convs = []
    names = {m: n for n, m in model.named_modules()}

    def record(mod, args, out):
        st, cache = args[0], args[1]
        if isinstance(mod, SparseConv3d):
            key = down_cache_key(st.spatial_shape, mod.kernel_size, mod.stride,
                                 mod.padding, args[2] if len(args) > 2 else None)
            out_indices, idx, _ = cache[key]
            valid = out_indices[:, 0] >= 0
        else:
            key = subm_cache_key(mod.indice_key or "", st.spatial_shape,
                                 mod.kernel_size, mod.dilation)
            idx, valid = cache[key], st.valid
        convs.append((names[mod], st.features, idx, mod.weight.detach(), valid))
    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, (SubMConv3d, SparseConv3d))]
    try:
        with torch.no_grad():
            out = model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return convs, out


def quant_sym(x, axis=None):
    """Symmetric int8 with per-tensor (axis None) or per-last-axis scale."""
    import torch
    amax = x.abs().amax() if axis is None else x.abs().amax(
        dim=tuple(range(x.dim() - 1)))
    s = (amax / 127.0).clamp(min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def kernel_conv(convs, flush, mode, label):
    """Phase ``kernel_conv`` for the recorded convs of one forward of model
    ``label``: kernel 1 against its plain version in f32, bf16 and s8 on
    each conv's real features, book and weights (f32 and bf16 within the
    stated tolerances, s8 bit-exact), timed beside its plain version,
    gather + ``torch.matmul`` / ``torch._int_mm`` and its bound; per conv,
    per (Cin, Cout, K) group and in total -> (bf16 totals, worst errors)."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    worst = {"f32": 0.0, "bf16": 0.0, "s8": 0.0}
    by_width = {}                    # (Cin, Cout, K) -> summed times
    under_library = {"bf16": 0, "s8": 0}   # convs at or under the library
    with torch.no_grad():
        for name, feats, idx, w32, valid in convs:
            n, cin = feats.shape
            m, k = idx.shape
            cout = w32.shape[2]
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            row = {"model": label, "conv": name, "N": n, "M": m, "K": k,
                   "Cin": cin, "Cout": cout, "present_taps": n_present}
            for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                f, w = feats.to(dt).contiguous(), w32.to(dt).contiguous()
                vk = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                                    impl="cuda")
                vp = gather_conv.sparse_gather_conv(f, idx, w, out_valid=valid,
                                                    impl="plain")
                torch.cuda.synchronize()
                err = (vk.float() - vp.float()).abs()
                mag = vp.float().abs()
                if tag == "f32":
                    # summation order only: relative to the output's scale
                    ok = float(err.max()) <= 1e-4 * max(1.0, float(mag.max()))
                else:
                    # one bf16 rounding of sums that differ in order: at most
                    # one ulp (2^-7 relative) per element
                    ok = bool((err <= 2.0 ** -7 * mag
                               + 1e-5 * max(1.0, float(mag.max()))).all())
                worst[tag] = max(worst[tag], float(err.max()))
                if not ok:
                    # the worst element's sum of |terms|: large against the
                    # element itself means heavy cancellation
                    at = int(err.argmax())
                    terms = gather_conv.gather_conv_plain(
                        f.float().abs(), idx, w.float().abs()).reshape(-1)[at]
                    check(False, f"{name} {tag}: kernel vs plain max err "
                                 f"{float(err.max())} (scale {float(mag.max())}"
                                 f"; worst element {at}: plain "
                                 f"{float(vp.reshape(-1)[at])}, sum|terms| "
                                 f"{float(terms)})")
                row[f"err_{tag}"] = float(err.max())
                row[f"ms_{tag}"] = time_ms(lambda: gather_conv.gather_conv_cuda(
                    f, idx, w, out_valid=valid), flush=flush)
                row[f"plain_ms_{tag}"] = time_ms(lambda: gather_conv.gather_conv_plain(
                    f, idx, w, out_valid=valid), reps=5, flush=flush)
                flat = torch.cat([f, f.new_zeros((1, cin))])
                safe = torch.where(present, idx.long(), n).reshape(-1)
                w2 = w.reshape(k * cin, cout)
                row[f"library_ms_{tag}"] = time_ms(
                    lambda: torch.matmul(flat[safe].reshape(m, k * cin), w2),
                    flush=flush)
                # each input read once (the rows the rulebook uses, the
                # table, the weights), the output written once; the
                # operations of the present taps only
                nbytes = (rows_read * cin + k * cin * cout + m * cout) \
                    * f.element_size() + m * k * 4
                row[f"bytes_ms_{tag}"] = 1e3 * nbytes / HBM_BYTES_PER_S
                row[f"ops_ms_{tag}"] = 1e3 * 2.0 * n_present * cin * cout \
                    / PEAK_OPS_PER_S[tag]
                row[f"bound_ms_{tag}"] = max(row[f"bytes_ms_{tag}"],
                                             row[f"ops_ms_{tag}"])
            # s8: exact s32 sums, and the scaled/masked epilogue bit-exact
            fq, s_f = quant_sym(feats.float())
            wq, s_w = quant_sym(w32.float(), axis=-1)
            scale = (s_f * s_w).float().contiguous()
            for kw in ({}, {"out_scale": scale, "out_valid": valid}):
                vk = gather_conv.sparse_gather_conv(fq, idx, wq, impl="cuda", **kw)
                vp = gather_conv.sparse_gather_conv(fq, idx, wq, impl="plain", **kw)
                check(torch.equal(vk, vp), f"{name} s8 {sorted(kw)}: kernel != plain")
            row["ms_s8"] = time_ms(lambda: gather_conv.gather_conv_cuda(
                fq, idx, wq, out_scale=scale, out_valid=valid), flush=flush)
            row["plain_ms_s8"] = time_ms(lambda: gather_conv.gather_conv_plain(
                fq, idx, wq, out_scale=scale, out_valid=valid), reps=5, flush=flush)
            flatq = torch.cat([fq, fq.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row["library_ms_s8"] = time_ms(
                lambda: torch._int_mm(flatq[safe].reshape(m, k * cin), wq2),
                flush=flush) if m > 16 else None
            nbytes = rows_read * cin + k * cin * cout + m * cout * 4 + m * k * 4
            row["bound_ms_s8"] = 1e3 * max(
                nbytes / HBM_BYTES_PER_S,
                2.0 * n_present * cin * cout / PEAK_OPS_PER_S["s8"])
            emit("kernel_conv", **row)
            for key in totals:
                totals[key] += row[f"{key}_bf16"]
            group = by_width.setdefault((cin, cout, k), {"convs": 0})
            group["convs"] += 1
            for tag in ("bf16", "s8"):
                for key in ("ms", "library_ms", "bound_ms"):
                    v, acc = row[f"{key}_{tag}"], group.get(f"{key}_{tag}", 0.0)
                    group[f"{key}_{tag}"] = None if v is None or acc is None \
                        else acc + v
                lib_ms = row[f"library_ms_{tag}"]
                under_library[tag] += lib_ms is not None \
                    and row[f"ms_{tag}"] <= lib_ms
    groups = []
    for (cin, cout, k), g in by_width.items():
        for tag in ("bf16", "s8"):
            lib_ms = g[f"library_ms_{tag}"]
            g[f"kernel_over_library_{tag}"] = None if lib_ms is None \
                else g[f"ms_{tag}"] / lib_ms
        groups.append({"Cin": cin, "Cout": cout, "K": k, **g})
    emit("kernel_conv_by_width", model=label, groups=groups,
         times="sums over the convs of each (Cin, Cout, K) group")
    emit("kernel_conv_total", model=label, dtype="bf16", convs=len(convs),
         **totals,
         convs_at_or_under_library=under_library,
         mode=mode(), max_abs_err=worst, tolerance={
             "f32": "max|k-p| <= 1e-4 * max(1, max|p|)",
             "bf16": "|k-p| <= 2^-7 |p| + 1e-5 * max(1, max|p|) per element",
             "s8": "bit-exact (s32 sums and scaled/masked output)"})
    return totals, worst


def kernel_launches(conv_k, nms_k):
    """Launch counts of both kernels, by entry (and the int8 convs'
    ``_int_mm`` calls, a library GEMM)."""
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import gather_conv
    entries = {"sparse_gather_conv_f32": "q3d_sparse_gather_conv_f32",
               "sparse_gather_conv_bf16": "q3d_sparse_gather_conv_bf16",
               "sparse_gather_conv_s8": "q3d_sparse_gather_conv_s8",
               "sparse_gather_conv_s8_requant": gather_conv.REQUANT_ENTRY}
    out = {k: conv_k.launches[e] for k, e in entries.items()}
    out["sparse_gather_conv_other"] = sum(conv_k.launches.values()) \
        - sum(out.values())
    return {**out, "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
            "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"],
            "int_mm_conv2d": dense_layers.INT_MM_CALLS["int8_conv2d"],
            "int_mm_conv2d_sq": dense_layers.INT_MM_CALLS["int8_conv2d_sq"]}


def clear_launches(conv_k, nms_k):
    from q3d_tpu_torch.models import layers as dense_layers
    conv_k.launches.clear()
    nms_k.launches.clear()
    dense_layers.INT_MM_CALLS.clear()


def detections_near(a, b, min_score, box_tol, score_tol):
    """Per-frame detections (lists of host dicts) -> (detections of either
    run scoring >= min_score, those with a partner of the same frame and
    label in the other run within box_tol and score_tol, worst box and
    score differences over the partnered ones)."""
    import numpy as np
    n = matched = 0
    worst = [0.0, 0.0]
    for x, y in ((a, b), (b, a)):
        for fx, fy in zip(x, y):
            for i in range(fx["final_valid"].shape[0]):
                vx, vy = fx["final_valid"][i], fy["final_valid"][i]
                for box, label, score in zip(fx["final_boxes"][i][vx],
                                             fx["final_labels"][i][vx],
                                             fx["final_scores"][i][vx]):
                    if score < min_score:
                        continue
                    n += 1
                    same = fy["final_labels"][i][vy] == label
                    if not same.any():
                        continue
                    db = np.abs(fy["final_boxes"][i][vy][same] - box).max(-1)
                    ds = np.abs(fy["final_scores"][i][vy][same] - score)
                    k = int(np.argmin(db))
                    if db[k] <= box_tol and ds[k] <= score_tol:
                        matched += 1
                        worst = [max(worst[0], float(db[k])),
                                 max(worst[1], float(ds[k]))]
    return n, matched, worst


def first_difference(model, batch):
    """One forward of ``model`` on ``batch`` through the kernels and through
    the plain versions, every conv, BN and quantizer output recorded in
    order -> the first one that differs (None if none does): its name,
    whether its inputs were equal, the share of elements that differ, the
    largest absolute difference, and that difference over the output's
    largest magnitude, also in units in the last place of that magnitude
    (an f32 sum taken in another order differs by a few of those; an
    element's own ulps mean nothing where its sum cancels to near 0)."""
    import torch
    from q3d_tpu_torch.models.layers import BatchNorm, Conv2d
    from q3d_tpu_torch.ops.spconv.modules import (SparseBatchNorm,
                                                  SparseConv3d, SubMConv3d)
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer

    def tensor(x):
        x = x[0] if isinstance(x, tuple) else x
        return (x.features if hasattr(x, "features") else x).detach().clone()
    names = {m: n for n, m in model.named_modules()}
    runs = {}
    for impl in ("cuda", "plain"):
        rec = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: rec.append(
                (names[mod], tensor(args[0]), tensor(out))))
            for m in model.modules()
            if isinstance(m, (SubMConv3d, SparseConv3d, SparseBatchNorm,
                              Conv2d, BatchNorm, TensorQuantizer))]
        model.set_kernel_impl(impl)
        try:
            with torch.no_grad():
                model(dict(batch))
            torch.cuda.synchronize()
        finally:
            model.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        runs[impl] = rec
    for (name, xk, yk), (_, xp, yp) in zip(runs["cuda"], runs["plain"]):
        if torch.equal(yk, yp):
            continue
        a, b = yk.double(), yp.double()
        diff = (a - b).abs()
        row = {"layer": name, "inputs_equal": torch.equal(xk, xp),
               "share_differing": float((diff > 0).double().mean()),
               "max_abs": float(diff.max()),
               "max_rel_to_scale": float(diff.max() / b.abs().max().clamp_min(
                   1e-30))}
        if yp.dtype == torch.float32:
            top = yp.abs().max()
            ulp = torch.nextafter(top, top.new_tensor(float("inf"))) - top
            row["ulps_of_scale"] = float(diff.max() / ulp.double())
        return row
    return None


def eval_gates(dev, conv_k, nms_k, mode):
    """Phases ``eval_gates`` and ``eval_plain``: the four gates of
    tests/test_accuracy_regression.py on the card.  The trained
    centerpoint_tiny fixture (read without JAX), its 16 test frames at
    batch 2 in f32, each recipe calibrated as the test calibrates it, then
    ``eval_one_epoch`` through the kernels (launch counts zeroed before and
    read after: kernel 1 and kernel 2 must have launched) and, on the same
    calibrated model, through the plain versions; the per-frame detections
    of the two are compared.  -> {recipe: summary}; raises if a gate or a
    comparison fails."""
    import numpy as np
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.eval_utils import eval_one_epoch
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.utils.checkpoint import load_flax_checkpoint
    from q3d_tpu_torch.utils.weights import state_dict_from_jax

    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    cfg.MODEL.POST_PROCESSING.EVAL_METRIC = "nuscenes"
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    names = list(cfg.CLASS_NAMES)
    state = state_dict_from_jax(load_flax_checkpoint(str(CKPT))[0])
    batch = load_data_to_device(next(iter(loader)), device=dev)

    def int8(extra):
        return lambda m: quant_api.prepare_int8_deploy(
            m, [batch, batch], recipe_kwargs=dict(quantize_first_conv=True,
                                                  extra_no_list=extra))

    def static_entropy(m):
        quant_api.quantize_model(m, quant_api.centerpoint_recipe(
            sq=False, static=True), batch)
        quant_api.collect_stats(m, [batch] * 3, num_batches=3)
        quant_api.compute_amax(m, method="entropy")
    recipes = {
        "fp32": lambda m: None,
        "int8_full": int8(()),
        "int8_head_bf16": int8(("dense_head.*",)),
        "sq_dynamic": lambda m: quant_api.quantize_model(
            m, quant_api.centerpoint_recipe(sq=True, alpha=0.5, static=False),
            batch),
        "static_entropy": static_entropy}
    n_batches = len(loader)
    results = {}
    for tag, prepare in recipes.items():
        m = build_network(cfg.MODEL, len(names), ds, device=dev)
        m.load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        prepare(m)
        calib_s = time.perf_counter() - t0
        # where the float runs first part, kernels against plain versions
        runs = {} if tag.startswith("int8") \
            else {"first_difference": first_difference(m, batch)}
        for impl in ("cuda", "plain"):
            m.set_kernel_impl(impl)
            clear_launches(conv_k, nms_k)
            frames = []
            t0 = time.perf_counter()
            res = eval_one_epoch(m, loader, ds, names, cfg, device=dev,
                                 per_frame=frames)
            runs[impl] = {"res": res, "frames": frames,
                          "launches": kernel_launches(conv_k, nms_k),
                          "eval_s": time.perf_counter() - t0}
        m.set_kernel_impl(None)
        results[tag] = {"calibration_s": calib_s, **runs}

    fp = {impl: results["fp32"][impl]["res"] for impl in ("cuda", "plain")}
    summary, failed = {}, []
    for tag, r in results.items():
        row = {"calibration_s": r["calibration_s"]}
        if "first_difference" in r:
            row["first_difference"] = r["first_difference"]
        for impl in ("cuda", "plain"):
            res = r[impl]["res"]
            drop = (fp[impl]["NDS"] - res["NDS"]) / max(fp[impl]["NDS"], 1e-9)
            row[impl] = {"NDS": res["NDS"], "mAP": res["mAP"],
                         "rel_nds_drop": drop,
                         "infer_time_ms": res["infer_time_ms"],
                         "eval_s": r[impl]["eval_s"],
                         "launches": r[impl]["launches"]}
            limit = GATES[tag]
            if tag == "fp32" and not (res["NDS"] > 0.4 and res["mAP"] > 0.3):
                failed.append(f"{tag} {impl}: NDS {res['NDS']} mAP {res['mAP']}")
            if limit is not None and drop > limit:
                failed.append(f"{tag} {impl}: NDS drop {drop} > {limit}")
        lk, lp = r["cuda"]["launches"], r["plain"]["launches"]
        conv_entry = "sparse_gather_conv_s8_requant" if tag.startswith("int8") \
            else "sparse_gather_conv_f32"
        if lk[conv_entry] != 21 * n_batches \
                or lk["greedy_nms_boxes"] != n_batches:
            failed.append(f"{tag}: kernel launches {lk}")
        if any(lp.values()):
            failed.append(f"{tag}: the plain run launched {lp}")
        fk, fpl = r["cuda"]["frames"], r["plain"]["frames"]
        if tag.startswith("int8"):
            # the s8 kernels are bit-exact, the float layers identical
            same = all(np.array_equal(a[k], b[k]) for a, b in zip(fk, fpl)
                       for k in a)
            row["plain_vs_kernels"] = {"tolerance": "every final array equal",
                                       "equal": same}
            if not same:
                failed.append(f"{tag}: detections differ, kernels vs plain")
        else:
            fq = tag != "fp32"
            tol = (FQ_MIN_SCORE, FQ_BOX_TOL, FQ_SCORE_TOL) if fq \
                else (0.0, 1e-3, 1e-4)
            n, matched, worst = detections_near(fk, fpl, *tol)
            counts = [sum(int(f["final_valid"].sum()) for f in x)
                      for x in (fk, fpl)]
            row["plain_vs_kernels"] = {
                "min_score": tol[0], "box_tol": tol[1], "score_tol": tol[2],
                "detections": n, "matched": matched, "worst": worst,
                "valid_counts": counts,
                "nds_diff": r["cuda"]["res"]["NDS"] - r["plain"]["res"]["NDS"]}
            if fq:
                ok = matched >= FQ_MATCH_SHARE * n \
                    and abs(counts[0] - counts[1]) <= FQ_COUNT_SHARE * max(counts) \
                    and abs(row["plain_vs_kernels"]["nds_diff"]) <= FQ_NDS_TOL
            else:
                ok = matched >= 0.99 * n
            if not ok:
                failed.append(f"{tag}: kernels vs plain {row['plain_vs_kernels']}")
        summary[tag] = row
        common = dict(recipe=tag, gate=GATES[tag], mode=mode(),
                      config=TINY_CFG.name, frames=len(ds), batch=BATCH,
                      calibration_s=row["calibration_s"])
        emit("eval_gates", **common, **row["cuda"])
        emit("eval_plain", **common, **row["plain"],
             plain_vs_kernels=row["plain_vs_kernels"],
             **{k: row[k] for k in ("first_difference",) if k in row})
    check(not failed, "eval gates: " + "; ".join(failed))
    return summary


def fakequant_ref(model, batch, conv_k, nms_k, mode, flush):
    """Phase ``fakequant_ref``: centerpoint_ref (seeded weights, BN
    calibrated) under dynamic SmoothQuant and under static entropy
    (calibrated on ``batch``), one forward each through the kernels and
    through the plain versions: spatial_features, every head map and the
    detections compared; CUDA-event times of each forward and each stage;
    the 12 BEV SmoothQuant convs timed beside cuDNN's bf16 conv."""
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.quant import api as quant_api

    models = {}
    m = copy.deepcopy(model)
    quant_api.quantize_model(m, quant_api.centerpoint_recipe(
        sq=True, alpha=0.5, static=False), batch)
    models["sq_dynamic"] = (m, 0.0)
    m = copy.deepcopy(model)
    quant_api.quantize_model(m, quant_api.centerpoint_recipe(
        sq=False, static=True), batch)
    quant_api.collect_stats(m, [batch], num_batches=1)
    t0 = time.perf_counter()
    quant_api.compute_amax(m, method="entropy")
    models["static_entropy"] = (m, time.perf_counter() - t0)
    out = {}
    for tag, (m, amax_s) in models.items():
        outs, launches, fwd_ms = {}, {}, {}
        with torch.no_grad():
            for impl in ("cuda", "plain"):
                m.set_kernel_impl(impl)
                clear_launches(conv_k, nms_k)
                outs[impl] = m(dict(batch))
                torch.cuda.synchronize()
                launches[impl] = kernel_launches(conv_k, nms_k)
                fwd_ms[impl] = time_ms(lambda: m(dict(batch)), reps=5)
        check(launches["cuda"]["sparse_gather_conv_f32"] == 21
              and launches["cuda"]["greedy_nms_boxes"] == 1
              and launches["cuda"]["sparse_gather_conv_s8_requant"] == 0,
              f"fakequant_ref {tag}: kernel launches {launches['cuda']}")
        check(not any(launches["plain"].values()),
              f"fakequant_ref {tag}: the plain run launched {launches['plain']}")
        ok_, op = outs["cuda"], outs["plain"]
        maps = {"spatial_features": (ok_["spatial_features"],
                                     op["spatial_features"]),
                "spatial_features_2d": (ok_["spatial_features_2d"],
                                        op["spatial_features_2d"])}
        for h, (pk, pp) in enumerate(zip(ok_["pred_dicts"], op["pred_dicts"])):
            for key in pk:
                maps[f"head{h}.{key}"] = (pk[key], pp[key])
        map_err = {}
        for key, (a, b) in maps.items():
            check(bool(torch.isfinite(a).all()), f"fakequant_ref {tag}: {key} "
                                                  f"not finite")
            err = (a - b).abs()
            mag = float(b.abs().max())
            map_err[key] = {"max_abs": float(err.max()), "scale": mag,
                            "share_over_1e-3": float(
                                (err > 1e-3 * max(mag, 1e-30)).float().mean())}
            check(float(err.max()) <= FQ_MAP_RTOL * max(mag, 1.0),
                  f"fakequant_ref {tag}: {key} kernels vs plain {map_err[key]}")
        hk, hp = to_host(ok_), to_host(op)
        n, matched, worst = detections_near([hk], [hp], FQ_MIN_SCORE,
                                            FQ_BOX_TOL, FQ_SCORE_TOL)
        counts = [int(hk["final_valid"].sum()), int(hp["final_valid"].sum())]
        check(matched >= FQ_MATCH_SHARE * n and abs(counts[0] - counts[1])
              <= FQ_COUNT_SHARE * max(counts),
              f"fakequant_ref {tag}: detections kernels vs plain: {matched}/"
              f"{n} matched, counts {counts}")
        m.set_kernel_impl(None)
        stages = stage_times(m, batch)
        # cuDNN's deterministic f32 algorithms (this phase's mode) against
        # its own choice, TF32 still off: the float convs of static PTQ
        # are cuDNN's
        torch.backends.cudnn.deterministic = False
        with torch.no_grad():
            fwd_ms["cuda_cudnn_any_algorithm"] = time_ms(
                lambda: m(dict(batch)), reps=5)
        torch.backends.cudnn.deterministic = True
        out[tag] = {"forward_ms": fwd_ms, "stages_ms": stages,
                    "launches": launches["cuda"], "map_err": map_err,
                    "map_tolerance": f"max|k-p| <= {FQ_MAP_RTOL} * max(1, "
                                     f"max|p|)",
                    "detections": n, "matched": matched, "worst": worst,
                    "valid_counts": counts, "entropy_amax_s": amax_s}
        emit("fakequant_ref", recipe=tag, config=CFG.name, batch=BATCH,
             dtype="f32", mode=mode(), **out[tag])

    # the 12 BEV SmoothQuant convs: im2col + fake-quant + torch.matmul (f32),
    # beside cuDNN's bf16 conv at the same shapes
    m = models["sq_dynamic"][0]
    seen = []
    hooks = [c.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for c in m.backbone_2d.modules() if isinstance(c, Conv2d)]
    with torch.no_grad():
        m(dict(batch))
    for h in hooks:
        h.remove()
    n_bev = sum(isinstance(c, Conv2d) for c in m.backbone_2d.modules())
    check(len(seen) == n_bev > 0, f"fakequant_ref: {len(seen)} of {n_bev} BEV "
                                  f"SQ convs ran")
    rows = []
    with torch.no_grad():
        for conv, x in seen:
            xb = x.to(torch.bfloat16).contiguous()
            wb = conv.weight.to(torch.bfloat16)
            o, c_in, kh, kw = conv.weight.shape
            b_, _, h_, w_ = x.shape
            ho = (h_ + 2 * conv.padding[0] - kh) // conv.stride[0] + 1
            wo = (w_ + 2 * conv.padding[1] - kw) // conv.stride[1] + 1
            mm, kk = b_ * ho * wo, c_in * kh * kw
            row = {"x": list(x.shape), "w": list(conv.weight.shape),
                   "stride": list(conv.stride), "gemm_mkn": [mm, kk, o],
                   "sq_f32_ms": time_ms(lambda: conv._smoothquant_conv(x),
                                        reps=5, flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, conv.stride, conv.padding), flush=flush)}
            # the f32 im2col GEMM's bound: the map read once, the patches
            # written and read, the output written; its f32 operations
            nbytes = 4 * (x.numel() + 2 * mm * kk + kk * o + mm * o)
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm * kk
                                        * o / PEAK_OPS_PER_S["f32"])
            rows.append(row)
            emit("sq_conv2d", **row)
    emit("sq_conv2d_total", convs=len(rows), mode=mode(),
         **{k: sum(r[k] for r in rows)
            for k in ("sq_f32_ms", "cudnn_bf16_ms", "bound_ms")})
    return out


def sq_int8_conv2d(m, req, flush, mode):
    """The BEV backbone's SmoothQuant int8 convs of ``m`` on their real
    inputs of ``req``: each conv (f32 im2col, column scales, quantize,
    ``_int_mm``, rescale) timed beside its ``_int_mm`` alone and beside
    cuDNN's bf16 conv at its shapes, with the bound of its s8 GEMM ->
    totals."""
    import torch
    from q3d_tpu_torch.models.layers import Conv2d
    seen = []
    convs = [c for c in m.backbone_2d.modules() if isinstance(c, Conv2d)]
    hooks = [c.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0]))) for c in convs]
    with torch.no_grad():
        m(dict(req))
    for h in hooks:
        h.remove()
    check(len(seen) == len(convs) > 0, f"sq_int8_conv2d: {len(seen)} of "
                                       f"{len(convs)} BEV convs ran")
    rows = []
    with torch.no_grad():
        for conv, x in seen:
            o, c_in, kh, kw = conv.weight.shape
            patches, (b_, ho, wo) = conv._unfold(x)
            mm, kk = b_ * ho * wo, c_in * kh * kw
            a8 = torch.randint(-127, 128, (mm, kk), dtype=torch.int8,
                               device=x.device)
            w8 = torch.randint(-127, 128, (o, kk), dtype=torch.int8,
                               device=x.device)
            xb = x.to(torch.bfloat16).contiguous()
            wb = conv.weight.to(torch.bfloat16)
            row = {"x": list(x.shape), "x_dtype": str(x.dtype),
                   "w": list(conv.weight.shape), "stride": list(conv.stride),
                   "gemm_mkn": [mm, kk, o],
                   "ms": time_ms(lambda: conv._smoothquant_int8_conv(x),
                                 reps=5, flush=flush),
                   "int_mm_ms": time_ms(lambda: torch._int_mm(a8, w8.t()),
                                        flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, conv.stride, conv.padding), flush=flush)}
            # the s8 GEMM's bound: its operands read once, the s32 written
            nbytes = mm * kk + kk * o + 4 * mm * o
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm * kk
                                        * o / PEAK_OPS_PER_S["s8"])
            rows.append(row)
            emit("sq_int8_conv2d", **row)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "int_mm_ms", "cudnn_bf16_ms", "bound_ms")}
    emit("sq_int8_conv2d_total", convs=len(rows), mode=mode(), **total)
    return total


def deploy_int8(model, req16, req32, conv_k, nms_k, mode, strict_f32, flush):
    """Phase ``deploy_int8``: centerpoint_ref (``model``: seeded weights, BN
    calibrated) under the three int8 deploy recipes without residency:
    ``int8_deploy_recipe()`` (dynamic, what tools/test.py --quant int8
    runs), ``(sq=True)`` (the PTQ driver's --deploy_int8) and
    ``(static=True)`` (calibrated on ``req16`` given twice, entropy amax).
    Per recipe: one forward of the bf16 request with the launch counts zeroed
    before and read after, held to the count of each entry the recipe's
    layers give; the f32 request (TF32 off) through the kernels and through
    the plain versions, every int8 map a quantizer emits, spatial_features
    and the detections equal; forwards of the int8 and the bf16 model in
    turns (CUDA events, the first round dropped); the device operations of
    a forward (``forward_trace``).  -> (per-recipe summary, the unfused s8
    entry's calls of one dynamic forward: (conv name, args))."""
    import torch
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.ops.spconv import modules as sp_modules
    from q3d_tpu_torch.ops.spconv.modules import SparseConv3d, SubMConv3d
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer

    recipes = {"dynamic": {}, "sq": {"sq": True}, "static": {"static": True}}
    summary, s8_calls = {}, []
    for tag, kw in recipes.items():
        m = copy.deepcopy(model)
        t0 = time.perf_counter()
        quant_api.quantize_model(m, quant_api.int8_deploy_recipe(**kw), req16)
        if kw.get("static"):
            quant_api.collect_stats(m, [req16, req16], num_batches=2)
            quant_api.compute_amax(m, method="entropy")
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        sparse = [c for c in m.modules()
                  if isinstance(c, (SubMConv3d, SparseConv3d))]
        dense8 = [c for c in m.modules() if isinstance(c, Conv2d)
                  and c.rule is not None]
        n_s8 = sum(c.rule is not None for c in sparse)
        expected = {"sparse_gather_conv_s8": n_s8,
                    "sparse_gather_conv_bf16": len(sparse) - n_s8,
                    "greedy_nms_boxes": 1,
                    "int_mm_conv2d_sq" if kw.get("sq") else "int_mm_conv2d":
                        len(dense8)}
        clear_launches(conv_k, nms_k)
        with torch.no_grad():
            out = m(dict(req16))
        torch.cuda.synchronize()
        launches = kernel_launches(conv_k, nms_k)
        check({k: v for k, v in launches.items() if v}
              == {k: v for k, v in expected.items() if v},
              f"deploy_int8 {tag}: launches {launches}, expected {expected}")
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"deploy_int8 {tag}: non-finite outputs")
        valid = out["final_valid"].sum(1).tolist()
        if tag == "dynamic":
            # the unfused s8 entry's calls, by conv, for kernel_conv_s8
            names = {c: n for n, c in m.named_modules()}
            current = [None]
            real = sp_modules.sparse_gather_conv

            def rec(*args, **kwargs):
                if args[0].dtype == torch.int8:
                    s8_calls.append((current[0], args))
                return real(*args, **kwargs)
            hooks = [c.register_forward_pre_hook(
                lambda mod, a: current.__setitem__(0, names[mod]))
                for c in sparse]
            sp_modules.sparse_gather_conv = rec
            try:
                with torch.no_grad():
                    m(dict(req16))
            finally:
                sp_modules.sparse_gather_conv = real
                for h in hooks:
                    h.remove()
            check(len(s8_calls) == n_s8, f"deploy_int8: {len(s8_calls)} s8 "
                                         f"calls recorded, expected {n_s8}")

        # kernels vs plain on the f32 request: exact
        strict_f32(True)
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]
        qnames = {q: n for n, q in m.named_modules()
                  if isinstance(q, TensorQuantizer)}
        hooks = [q.register_forward_hook(
            lambda mod, a, o: grabbed[impl_now[0]].append((qnames[mod], o)))
            for q, n in qnames.items() if not n.endswith("weight_quant")]
        outs, plain_launches = {}, None
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m(dict(req32))
                    torch.cuda.synchronize()
                    plain_launches = kernel_launches(conv_k, nms_k)
        finally:
            m.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        strict_f32(False)
        check(not any(plain_launches.values()),
              f"deploy_int8 {tag}: the plain run launched {plain_launches}")
        gk, gp = grabbed["cuda"], grabbed["plain"]
        check(len(gk) == len(gp) > 0 and [n for n, _ in gk] == [n for n, _ in gp]
              and all(o[0].dtype == torch.int8 for _, o in gk),
              f"deploy_int8 {tag}: int8 maps {len(gk)} vs {len(gp)}")
        bad = [n for (n, a), (_, b) in zip(gk, gp)
               if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
        check(not bad, f"deploy_int8 {tag}: int8 maps differ at {bad[:5]}")
        for key in ("spatial_features", "final_boxes", "final_scores",
                    "final_labels", "final_valid"):
            check(torch.equal(outs["cuda"][key], outs["plain"][key]),
                  f"deploy_int8 {tag}: {key} differs, kernels vs plain")

        sq_total = sq_int8_conv2d(m, req16, flush, mode) if kw.get("sq") \
            else None

        # the int8 and the bf16 model in turns, CUDA events
        fwd = {"int8": [], "bf16": []}
        with torch.no_grad():
            for _ in range(6):
                for t_, mdl in (("int8", m), ("bf16", model)):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    a.record()
                    mdl(dict(req16))
                    b.record()
                    torch.cuda.synchronize()
                    fwd[t_].append(a.elapsed_time(b))
        med = {k: statistics.median(v[1:]) for k, v in fwd.items()}
        args = ", ".join(f"{k}={v}" for k, v in kw.items())
        summary[tag] = {"recipe": f"int8_deploy_recipe({args})",
                        "prepare_s": prep_s, "launches": launches,
                        "expected_launches": expected,
                        "int8_maps_equal": len(gk), "forward_ms": med["int8"],
                        "bf16_forward_ms": med["bf16"],
                        "int8_vs_bf16": med["bf16"] / med["int8"],
                        "valid_detections": valid,
                        "trace": forward_trace(m, req16),
                        **({} if sq_total is None
                           else {"bev_sq_int8_conv2d": sq_total})}
        emit("deploy_int8", config=CFG.name, batch=BATCH, mode=mode(),
             equal="every int8 map a quantizer emits, spatial_features and "
                   "final boxes/scores/labels/valid, kernels vs plain (f32 "
                   "request, exact)", timed="bf16 request, in turns",
             **summary[tag])
        del m
    return summary, s8_calls


def kernel_conv_s8(s8_calls, flush, mode):
    """Phase ``kernel_conv_s8``: kernel 1's unfused s8 entry on the real
    int8 features, books, weights, rescales and row masks of one forward
    under ``int8_deploy_recipe()``: bit-equal to its plain version, and
    timed beside it, beside the library form (gather + ``torch._int_mm``,
    the s32 sums without the rescale) and beside its bound.  -> totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    with torch.no_grad():
        for name, (f, idx, wq, osc, valid) in s8_calls:
            n, cin = f.shape
            m, k = idx.shape
            cout = wq.shape[2]
            y_k = gather_conv.gather_conv_cuda(f, idx, wq, osc, valid)
            y_p = gather_conv.gather_conv_plain(f, idx, wq, osc, valid)
            torch.cuda.synchronize()
            check(torch.equal(y_k, y_p), f"{name} s8: kernel != plain")
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            flatq = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       f, idx, wq, osc, valid), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       f, idx, wq, osc, valid), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch._int_mm(
                       flatq[safe].reshape(m, k * cin), wq2), flush=flush)}
            # inputs read once (the rows the book uses, the book, the
            # weights, the rescale, the row mask), the f32 output written
            # once; the present taps' operations
            nbytes = rows_read * cin + m * k * 4 + k * cin * cout \
                + 4 * cout + m + 4 * m * cout
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["s8"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit("kernel_conv_s8", **row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    emit("kernel_conv_s8_total", convs=len(s8_calls), **totals,
         recipe="int8_deploy_recipe()", mode=mode(), max_abs_err=0,
         tolerance="bit-exact (f32 outputs of exact s32 sums, equal)",
         library="gather + torch._int_mm (the s32 sums without the rescale)")
    return totals


def driver_tiny(conv_k, nms_k, mode, fp32_nds):
    """Phase ``driver_tiny``: the port's PTQ driver
    (``q3d_tpu_torch.tools.quant_driver``) on the trained centerpoint_tiny
    fixture on the card, nuScenes metric, with ``--deploy_int8`` and with
    ``--deploy_int8 --no_sq``: fp32 and quantized NDS / mAP and the relative
    drop; fp32 NDS equal to this run's ``eval_gates`` fp32 NDS within 1e-6;
    the quantized final scores within the JAX package's bound for the
    recipe (``tests/test_quant_model_e2e.py:72``: mean |fp - q| < 0.05);
    launches counted over the run (fp32 eval, the seed pass, the quantized
    eval)."""
    import numpy as np
    from q3d_tpu_torch.tools import quant_driver
    out = {}
    for tag, extra in (("deploy_int8", []), ("deploy_int8_no_sq", ["--no_sq"])):
        frames = {}
        clear_launches(conv_k, nms_k)
        t0 = time.perf_counter()
        fp, q = quant_driver.run(argv=[
            "--cfg_file", str(TINY_CFG), "--ckpt", str(CKPT), "--deploy_int8",
            *extra, "--device", "cuda",
            "--set", "MODEL.POST_PROCESSING.EVAL_METRIC", "nuscenes"],
            frames=frames)
        run_s = time.perf_counter() - t0
        launches = kernel_launches(conv_k, nms_k)
        n = len(frames["fp"])
        score_diff = float(np.mean([
            np.abs(a["final_scores"] - b["final_scores"]).mean()
            for a, b in zip(frames["fp"], frames["quant"])]))
        row = {"fp32": {"NDS": fp["NDS"], "mAP": fp["mAP"]},
               "quant": {"NDS": q["NDS"], "mAP": q["mAP"],
                         "infer_time_ms": q["infer_time_ms"]},
               "rel_nds_drop": (fp["NDS"] - q["NDS"]) / fp["NDS"],
               "mean_abs_score_diff": score_diff, "batches": n,
               "launches": launches, "run_s": run_s,
               "eval_gates_fp32_nds": fp32_nds}
        # fp32 eval: 21 f32 convs a batch; the seed pass and the quantized
        # eval: conv_input in f32, 20 s8 convs; one NMS a forward
        want = {"sparse_gather_conv_f32": 21 * n + 1 + n,
                "sparse_gather_conv_s8": 20 * (n + 1),
                "greedy_nms_boxes": 2 * n + 1}
        check({k: launches[k] for k in want} == want,
              f"driver_tiny {tag}: launches {launches}, expected {want}")
        check(abs(fp["NDS"] - fp32_nds) <= 1e-6,
              f"driver_tiny {tag}: fp32 NDS {fp['NDS']} != eval_gates "
              f"{fp32_nds}")
        check(score_diff < 0.05, f"driver_tiny {tag}: mean |fp - q| score "
                                 f"{score_diff} >= 0.05")
        out[tag] = row
        emit("driver_tiny", recipe=tag, config=TINY_CFG.name, mode=mode(),
             score_bound="mean |fp - q| final_scores < 0.05 "
                         "(tests/test_quant_model_e2e.py:72)", **row)
    return out


def kitti_model(name, dev, conv_k, nms_k, mode, strict_f32):
    """Phases ``serving_<name>``, ``stages_<name>`` and ``model_<name>``:
    the KITTI config's MODEL at full width on KITTI-geometry synthetic
    scenes, seeded random weights (conv_cls's prior bias set to 0, so that
    the score threshold passes candidates as a trained model's scores do),
    BN statistics calibrated on the first request (f32, TF32 off).

    serving: 4 requests of batch 2 in bf16, host time (scene + voxelize)
    and device forward each, launches zeroed before and read after (kernel
    1: KITTI_CONVS a forward; kernel 2's boxes form: one a forward, at K =
    NMS_PRE_MAXSIZE); stages: CUDA events per stage of one bf16 forward;
    model: one f32 request (TF32 off) through the kernels and through the
    plain versions: spatial_features, the cls / box / dir maps (within
    1e-4 of scale) and the detections (matched), the NMS keep masks of
    both forms on identical candidates and post_processing on identical
    inputs equal.  -> dict of what later phases need."""
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti_synthetic import (
        CAMERA, SCENE, kitti_config, kitti_scene, scene_counts)
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops.iou3d_nms import candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.tools.nms_ab import anchor_candidates
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    cfg = kitti_config(name, BATCH * REQUESTS, SEED)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=BATCH, training=False)
    counts = scene_counts(ds)
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[-1].MAX_NUMBER_OF_VOXELS["test"])
    # the cap must not bind: a capped frame loses the objects, which
    # make_scene puts last
    check(all(KITTI_MIN_VOXELS[name] <= c["voxels_kept"]
              == c["voxels_occupied"] < cap for c in counts),
          f"{name}: voxels kept {[c['voxels_kept'] for c in counts]}, "
          f"occupied {[c['voxels_occupied'] for c in counts]}, cap {cap}")
    check(all(c["objects_present"] == c["objects_labelled"] > 0
              for c in counts), f"{name}: objects lost: {counts}")
    emit(f"data_{name}", config=f"kitti_models/{name}.yaml",
         dataset="SyntheticDataset at the config's geometry, FOV-cropped",
         scene=SCENE, camera=CAMERA,
         point_cloud_range=list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
         voxel_size=[float(v) for v in ds.voxel_size],
         grid_size=[int(g) for g in ds.grid_size], voxel_cap=cap,
         frames=counts)
    t0 = time.perf_counter()
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    head = model.dense_head
    with torch.no_grad():
        head.conv_cls.bias.zero_()
    build_s = time.perf_counter() - t0
    raw0, _, _ = make_request(ds, 0, kitti_scene)
    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)
    calibrate_bns(model, batch_f32)
    strict_f32(False)

    # ------------------------------------------------------------ serving
    nms_cfg = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    pre, post_max = int(nms_cfg.NMS_PRE_MAXSIZE), int(nms_cfg.NMS_POST_MAXSIZE)
    k_seen = []                       # K of each boxes-form launch
    real_boxes_cuda = nms_mod.greedy_suppress_boxes_cuda

    def seen(corners, *args, **kw):
        k_seen.append(int(corners.shape[1]))
        return real_boxes_cuda(corners, *args, **kw)
    nms_mod.greedy_suppress_boxes_cuda = seen
    clear_launches(conv_k, nms_k)
    per_request = []
    try:
        for r in range(REQUESTS):
            raw, scene_ms, vox_ms = make_request(ds, r, kitti_scene)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = load_data_to_device(raw, device=dev,
                                        compute_dtype=torch.bfloat16)
            with torch.no_grad():
                out = model(batch)
            n_valid = out["final_valid"].sum(dim=1).tolist()
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
            check(all(torch.isfinite(out[k].float()).all() for k in
                      ("spatial_features_2d", "batch_box_preds",
                       "final_boxes", "final_scores")),
                  f"{name} request {r}: non-finite outputs")
            check(out["final_boxes"].shape == (BATCH, post_max, 7),
                  f"{name} request {r}: final_boxes shape "
                  f"{tuple(out['final_boxes'].shape)}")
            per_request.append({"request": r,
                                "frames": list(range(BATCH * r,
                                                     BATCH * (r + 1))),
                                "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                                "device_forward_ms": fwd_ms,
                                "valid_detections": n_valid})
            emit(f"serving_{name}_request", **per_request[-1])
    finally:
        nms_mod.greedy_suppress_boxes_cuda = real_boxes_cuda
    launches = kernel_launches(conv_k, nms_k)
    want = {"conv": KITTI_CONVS[name] * REQUESTS, "nms_boxes": REQUESTS,
            "nms_iou": 0, "nms_k": [pre] * REQUESTS}
    got = {"conv": sum(conv_k.launches.values()),
           "nms_boxes": launches["greedy_nms_boxes"],
           "nms_iou": launches["greedy_nms_iou"], "nms_k": k_seen}
    check(got == want, f"{name} main path launches {got}, expected {want}")
    emit(f"serving_{name}", config=f"kitti_models/{name}.yaml", batch=BATCH,
         dtype="bf16", requests=REQUESTS, launches=launches, nms_k=k_seen,
         anchors=int(head.anchors.shape[0]), build_s=build_s, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))
    stages = stage_times(model, batch)
    emit(f"stages_{name}", dtype="bf16", batch=BATCH, mode=mode(), ms=stages)

    # ------------------------------------- whole model, kernels vs plain
    strict_f32(True)
    convs = []
    with torch.no_grad():
        model.set_kernel_impl("cuda")
        clear_launches(conv_k, nms_k)
        if KITTI_CONVS[name]:
            convs, out_k = record_sparse_convs(model, batch_f32)
        else:
            out_k = model(dict(batch_f32))
        torch.cuda.synchronize()
        cuda_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl("plain")
        clear_launches(conv_k, nms_k)
        out_p = model(dict(batch_f32))
        torch.cuda.synchronize()
        plain_launches = kernel_launches(conv_k, nms_k)
        model.set_kernel_impl(None)
    check(sum(conv_k.launches.values()) == 0 and not any(
        plain_launches.values()), f"model_{name}: the plain run launched "
                                  f"{plain_launches}")
    check(len(convs) == KITTI_CONVS[name] and cuda_launches[
        "greedy_nms_boxes"] == 1, f"model_{name}: kernel run launched "
                                  f"{cuda_launches}, {len(convs)} convs")
    map_err = {}
    for key in ("spatial_features", "spatial_features_2d", "cls_preds",
                "box_preds", "dir_cls_preds"):
        a, b = out_k[key], out_p[key]
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = {"max_abs": err, "scale": mag}
        check(err <= KITTI_MAP_RTOL * max(1.0, mag),
              f"model_{name} f32 {key}: kernels vs plain max err {err} "
              f"(scale {mag})")
    cand, cand_valid, prior_valid = anchor_candidates(out_k, cfg)
    thresh = float(nms_cfg.NMS_THRESH)
    with torch.no_grad():
        check(torch.equal(
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="cuda"),
            nms_mod.greedy_nms_boxes(cand, cand_valid, thresh, impl="plain")),
            f"model_{name}: NMS keep masks (boxes form) differ on identical "
            f"candidates")
        iou, iou_valid = candidate_iou(cand, cand_valid)
        check(torch.equal(nms_mod.greedy_nms(iou, iou_valid, thresh,
                                             impl="cuda"),
                          nms_mod.greedy_nms(iou, iou_valid, thresh,
                                             impl="plain")),
              f"model_{name}: NMS keep masks (IoU form) differ on identical "
              f"candidates")
        del iou
        finals = []
        for impl in ("cuda", "plain"):
            model.kernel_impl = impl
            finals.append(model.post_processing(
                {k: out_k[k] for k in ("batch_cls_preds", "batch_box_preds",
                                       "cls_preds_normalized")}))
        model.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"model_{name}: {key} differs between NMS kernel and plain on "
              f"identical inputs")
    # end to end: every valid detection of one run has a partner in the
    # other (same label, box within 1e-3, score within 1e-4)
    matched = total = 0
    for a, b in ((out_k, out_p), (out_p, out_k)):
        for i in range(BATCH):
            va, vb = a["final_valid"][i], b["final_valid"][i]
            ba, bb = a["final_boxes"][i][va], b["final_boxes"][i][vb]
            total += len(ba)
            if len(ba) == 0 or len(bb) == 0:
                continue
            ok = ((ba[:, None, :] - bb[None, :, :]).abs().amax(-1) <= 1e-3) \
                & (a["final_labels"][i][va][:, None]
                   == b["final_labels"][i][vb][None, :]) \
                & ((a["final_scores"][i][va][:, None]
                    - b["final_scores"][i][vb][None, :]).abs() <= 1e-4)
            matched += int(ok.any(1).sum())
    frac = matched / max(total, 1)
    check(total > 0 and frac >= 0.99,
          f"model_{name}: only {matched}/{total} detections matched")
    emit(f"model_{name}", dtype="f32", mode=mode(), map_max_abs_err=map_err,
         map_tolerance=f"max|k-p| <= {KITTI_MAP_RTOL} * max(1, max|p|)",
         launches=cuda_launches,
         nms_identical_inputs=f"keep masks (both forms, K={cand.shape[1]}) "
         "and post_processing's detections equal",
         candidates_valid=cand_valid.sum(1).tolist(),
         candidates_valid_under_prior_bias=prior_valid.sum(1).tolist(),
         detections_matched=matched, detections=total, matched_fraction=frac)
    strict_f32(False)
    return {"model": model, "cfg": cfg, "batch_f32": batch_f32,
            "convs": convs, "cand": (cand, cand_valid, prior_valid),
            "launches": launches}


def boxes_bound(s, k, cand_pairs, near_pairs, clock_mhz):
    """Kernel 2's boxes form, three terms in ms: corners, areas and valid
    read once and keep written once (bytes); the circle test of every
    needed pair and the IoU of each near pair (operations, f32, as
    csrc/greedy_nms.cu counts them); the sweep's chain of K steps at >= 4
    cycles each (latency)."""
    return {"bytes": 1e3 * s * k * (32 + 4 + 1 + 1) / HBM_BYTES_PER_S,
            "operations": 1e3 * (cand_pairs * IOU_CIRCLE_OPS
                                 + near_pairs * IOU_OPS)
            / PEAK_OPS_PER_S["f32"],
            "latency": 1e3 * k * 4 / (clock_mhz * 1e6)}


def kernel_nms_wide(kitti, flush, mode, clock_mhz):
    """Phase ``kernel_nms`` at the anchor heads' widths (K > 2048, two mask
    words a sweep lane): the IoU form on random IoU matrices and the boxes
    form on random crowded boxes, K = 2049 and 4096, thresh 0.01 (the
    KITTI configs') and 0.5, and on both models' real candidate sets (K =
    4096): keep masks equal to the plain versions', the boxes form's IoU
    bit-equal at every pair it evaluated and 0 at every needed pair it
    skipped.  Then the boxes form timed on each model's candidates beside
    its plain version and its three-term bound, under three validities:
    every candidate valid, as the seeded models' zero conv_cls bias gives them (the main
    path's input and kernel 2's worst case), valid as conv_cls's prior
    bias would leave them, and the first 512 valid (``nms_ab.validities``).
    -> {model: row of the main path's input}."""
    import numpy as np
    import torch
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.tools.nms_ab import _crowded, validities
    dev = next(iter(kitti.values()))["cand"][0].device
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    for kk in WIDE_K:
        r_iou = torch.rand((2, kk, kk), generator=g, device=dev)
        r_valid = torch.rand((2, kk), generator=g, device=dev) > 0.1
        for th in (0.01, 0.5):
            check(torch.equal(nms_mod.greedy_nms(r_iou, r_valid, th,
                                                 impl="cuda"),
                              nms_mod.greedy_nms(r_iou, r_valid, th,
                                                 impl="plain")),
                  f"greedy_nms: random K={kk} thresh={th} keep masks differ")
        del r_iou
        r_boxes, r_valid = _crowded(rng, 2, kk, dev)
        for th in (0.01, 0.5):
            check_boxes_form(r_boxes, r_valid, th, f"random K={kk}")
    rows = {}
    for name, k_ in kitti.items():
        cand, all_valid, prior_valid = k_["cand"]
        th = float(k_["cfg"].MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
        corners, areas = nms_mod.bev_corners_areas(cand)
        s, k = all_valid.shape
        for share, valid in validities(all_valid, prior_valid):
            near, needed, most = check_boxes_form(
                cand, valid, th, f"{name} candidates, {share}")
            terms = boxes_bound(s, k, needed, near, clock_mhz)
            row = {"model": name, "entry": "q3d_greedy_nms_boxes",
                   "sets": s, "K": k, "thresh": th, "validity": share,
                   "valid": valid.sum(1).tolist(), "candidate_pairs": needed,
                   "near_pairs": near, "near_pairs_most_in_a_tile": most,
                   "kept": int(nms_mod.greedy_nms_boxes(cand, valid,
                                                        th).sum()),
                   "ms": time_ms(
                       lambda: nms_mod.greedy_suppress_boxes_cuda(
                           corners, areas, valid, th), flush=flush),
                   "plain_ms": time_ms(
                       lambda: nms_mod.greedy_suppress_boxes_plain(
                           cand, valid, th), reps=3, flush=flush),
                   **{f"{t}_ms": v for t, v in terms.items()},
                   "kernel_us": kernel_device_us(
                       lambda: nms_mod.greedy_suppress_boxes_cuda(
                           corners, areas, valid, th),
                       ("nms_box_pairs_kernel", "nms_box_iou_kernel",
                        "nms_sweep_kernel"), flush)}
            row["bound_by"] = max(terms, key=terms.get)
            row["bound_ms"] = terms[row["bound_by"]]
            rows.setdefault(name, row)
            emit("kernel_nms", form="boxes", **row, max_abs_err=0,
                 mode=mode(), clock_max_sm_mhz=clock_mhz,
                 tolerance="keep masks exactly equal, IoU bit-equal at every "
                 "evaluated pair, plain IoU exactly 0 at every skipped "
                 "needed pair (real candidates under each validity + "
                 "random K=2049/4096 x thresh 0.01/0.5); IoU form keep "
                 "masks equal on random K=2049/4096")
    return rows


def recipes_kitti(kitti, conv_k, nms_k, mode, strict_f32):
    """Phase ``recipes_kitti``: one f32 request (TF32 off) through the
    kernels and through the plain versions for SECOND under
    ``second_recipe()`` and PointPillars under ``pointpillar_recipe()``
    (dynamic SmoothQuant fake-quant: every map within KITTI_MAP_RTOL of its
    scale, the detections as sets with the FQ_* tolerances) and SECOND
    under ``int8_deploy_recipe()`` (every int8 map a quantizer emits,
    spatial_features and the detections equal; launches held to the
    recipe's layers: 11 s8, 1 f32 conv_input, one ``_int_mm`` per BEV conv
    (12), 1 NMS).
    -> {recipe: summary}."""
    import torch
    from q3d_tpu_torch.eval_utils import to_host
    from q3d_tpu_torch.models.layers import Conv2d
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import TensorQuantizer
    cases = (("second", "second_recipe()", quant_api.second_recipe()),
             ("pointpillar", "pointpillar_recipe()",
              quant_api.pointpillar_recipe()),
             ("second", "int8_deploy_recipe()",
              quant_api.int8_deploy_recipe()))
    strict_f32(True)
    summary = {}
    for name, tag, rules in cases:
        batch = kitti[name]["batch_f32"]
        m = copy.deepcopy(kitti[name]["model"])
        quant_api.quantize_model(m, rules, batch)
        int8 = "int8" in tag
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]
        qnames = {q: n for n, q in m.named_modules()
                  if isinstance(q, TensorQuantizer)}
        hooks = [q.register_forward_hook(
            lambda mod, a, o: grabbed[impl_now[0]].append((qnames[mod], o)))
            for q, n in qnames.items() if int8
            and not n.endswith("weight_quant")]
        outs, launches = {}, {}
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m.set_kernel_impl(impl)
                    clear_launches(conv_k, nms_k)
                    outs[impl] = m(dict(batch))
                    torch.cuda.synchronize()
                    launches[impl] = kernel_launches(conv_k, nms_k)
        finally:
            m.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        n_conv = KITTI_CONVS[name]
        want = {"greedy_nms_boxes": 1}
        if int8:
            # conv_input float; one _int_mm per quantized dense conv (the
            # BEV backbone's 12 at KITTI width)
            want.update(sparse_gather_conv_s8=n_conv - 1,
                        sparse_gather_conv_f32=1, int_mm_conv2d=sum(
                            isinstance(c, Conv2d) and c.rule is not None
                            for c in m.modules()))
        elif n_conv:
            want["sparse_gather_conv_f32"] = n_conv
        check({k: v for k, v in launches["cuda"].items() if v} == want,
              f"recipes_kitti {name} {tag}: launches {launches['cuda']}, "
              f"expected {want}")
        check(not any(launches["plain"].values()),
              f"recipes_kitti {name} {tag}: the plain run launched "
              f"{launches['plain']}")
        ok_, op = outs["cuda"], outs["plain"]
        row = {"model": name, "recipe": tag, "launches": launches["cuda"],
               "valid": [int(ok_["final_valid"].sum()),
                         int(op["final_valid"].sum())]}
        if int8:
            gk, gp = grabbed["cuda"], grabbed["plain"]
            check(len(gk) == len(gp) > 0
                  and [n for n, _ in gk] == [n for n, _ in gp],
                  f"recipes_kitti {tag}: int8 maps {len(gk)} vs {len(gp)}")
            bad = [n for (n, a), (_, b) in zip(gk, gp)
                   if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
            check(not bad, f"recipes_kitti {tag}: int8 maps differ at "
                           f"{bad[:5]}")
            for key in ("spatial_features", "final_boxes", "final_scores",
                        "final_labels", "final_valid"):
                check(torch.equal(ok_[key], op[key]),
                      f"recipes_kitti {tag}: {key} differs, kernels vs plain")
            row.update(int8_maps_equal=len(gk),
                       equal="every int8 map, spatial_features, detections")
        else:
            map_err = {}
            for key in ("spatial_features", "spatial_features_2d",
                        "cls_preds", "box_preds", "dir_cls_preds"):
                a, b = ok_[key], op[key]
                err, mag = float((a - b).abs().max()), float(b.abs().max())
                map_err[key] = {"max_abs": err, "scale": mag}
                check(bool(torch.isfinite(a).all())
                      and err <= KITTI_MAP_RTOL * max(mag, 1.0),
                      f"recipes_kitti {name} {tag}: {key} {map_err[key]}")
            hk, hp = to_host(ok_), to_host(op)
            n, matched, worst = detections_near([hk], [hp], FQ_MIN_SCORE,
                                                FQ_BOX_TOL, FQ_SCORE_TOL)
            counts = row["valid"]
            check(n > 0 and matched >= FQ_MATCH_SHARE * n
                  and abs(counts[0] - counts[1])
                  <= FQ_COUNT_SHARE * max(counts),
                  f"recipes_kitti {name} {tag}: {matched}/{n} detections "
                  f"matched, counts {counts}")
            row.update(map_err=map_err, detections=n, matched=matched,
                       worst=worst, map_tolerance=f"max|k-p| <= "
                       f"{KITTI_MAP_RTOL} * max(1, max|p|)")
        summary[f"{name} {tag}"] = row
        emit("recipes_kitti", dtype="f32", mode=mode(), batch=BATCH, **row)
        del m
    strict_f32(False)
    return summary



# ================================================================ training
# the gradient checks: loss within 1e-5 relative, every parameter's gradient
# within 1e-4 of its tensor's largest |g|, BN running statistics within 1e-5
# (of max(1, their scale)).  A whole QAT (8-bit fake-quant) step is
# ill-conditioned: a last-bit difference can move an activation across a
# rounding boundary, and the gradients with it (readings in PERF.md, from
# tests/test_torch_port_train_step.py): loss within 2e-2, the gradients'
# cosine >= 0.95 and relative L2 <= 0.35, above every reading; each conv's
# kernel launches in the QAT step are held at 1e-5 of their plain versions
# on their own operands (hold_conv_launches)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5}
QAT_TOL = {"loss": 2e-2, "cos": 0.95, "rel_l2": 0.35, "stats": 1e-3}
TRAIN_EPOCHS = 2
TINY_STEPS = 8
QAT_STEPS = 4
# from the trained fixture: momentum SGD (Adam's first updates move every
# weight by about +-lr, which undoes a trained model)
QAT_OPTIM = {"OPTIMIZER": "sgd", "LR": 0.003, "MOMENTUM": 0.9,
             "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10}


@contextlib.contextmanager
def recording_backward(model):
    """While open, each sparse conv's backward under autograd (which runs
    on as it does) also appends (conv name, features, weight, book,
    out_valid, inverse book, grad_out) to the list it yields: the inputs
    of the model's kernel-1 launches for the forward and the input
    gradient."""
    from q3d_tpu_torch.ops.spconv import gather_conv
    names = {p.data_ptr(): n for n, p in model.named_parameters()}
    recorded = []
    real_bwd = gather_conv._GatherConvFn.backward

    def capture(ctx, grad_out):
        f, w, idx, _, ov = ctx.saved_tensors
        recorded.append((names.get(w.data_ptr(), "?"), f.detach(), w.detach(),
                         idx, ov, ctx.inverse(), grad_out.detach()))
        return real_bwd(ctx, grad_out)
    gather_conv._GatherConvFn.backward = staticmethod(capture)
    try:
        yield recorded
    finally:
        gather_conv._GatherConvFn.backward = staticmethod(real_bwd)


def compare_training(mk, mp, loss_k, loss_p, qat=False):
    """The kernels' training step (``mk``) against the plain versions'
    (``mp``), after the same step from the same state: loss, every
    parameter's gradient, every BN's running statistics -> summary dict;
    raises past the tolerances (``TRAIN_TOL``, or ``QAT_TOL``)."""
    import torch
    from q3d_tpu_torch.train_utils import biases_before_bn
    zero = biases_before_bn(mk)
    pk, pp = dict(mk.named_parameters()), dict(mp.named_parameters())
    top = max(float(p.grad.abs().max()) for p in pp.values())
    worst, num, den, dot, nk = (0.0, ""), 0.0, 0.0, 0.0, 0.0
    for name, p in pp.items():
        gk, gp = pk[name].grad, p.grad
        check(gk is not None and bool(torch.isfinite(gk).all()),
              f"{name}: kernels' gradient missing or not finite")
        err, scale = float((gk - gp).abs().max()), float(gp.abs().max())
        if name in zero:
            check(max(scale, float(gk.abs().max())) <= 1e-5 * top,
                  f"{name}: a bias before a train-mode BN has gradient "
                  f"{scale} (largest of the model {top})")
            continue
        num += float((gk - gp).double().pow(2).sum())
        den += float(gp.double().pow(2).sum())
        dot += float((gk.double() * gp.double()).sum())
        nk += float(gk.double().pow(2).sum())
        rel = err / max(scale, 1e-30)
        if not qat:
            check(err <= TRAIN_TOL["grad"] * scale,
                  f"{name}: gradient kernels vs plain {err} (scale {scale})")
        worst = max(worst, (rel, name))
    rel_l2, cos = (num / den) ** 0.5, dot / (den * nk) ** 0.5
    tol = QAT_TOL if qat else TRAIN_TOL
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel <= tol["loss"], f"loss kernels {loss_k} vs plain {loss_p}")
    if qat:
        check(cos >= QAT_TOL["cos"] and rel_l2 <= QAT_TOL["rel_l2"],
              f"QAT gradients: cosine {cos}, relative L2 {rel_l2}")
    bk, bp = dict(mk.named_buffers()), dict(mp.named_buffers())
    stats_err = 0.0
    for name, b in bp.items():
        if name.endswith(("running_mean", "running_var")):
            e = float((bk[name] - b).abs().max()) \
                / max(1.0, float(b.abs().max()))
            check(e <= tol["stats"], f"{name}: kernels vs plain {e}")
            stats_err = max(stats_err, e)
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_rel, "grad_worst_rel": worst[0],
            "grad_worst_param": worst[1], "grad_rel_l2": rel_l2,
            "grad_cosine": cos, "bn_stats_worst": stats_err,
            "zero_grad_biases": len(zero), "params": len(pp)}


FIRST_CONV = "backbone_3d.conv_input.0.weight"     # its input takes no dX


def train_grad(model, batch, conv_k, mode, tag="train_grad", config=CFG.name,
               convs=21):
    """Phase ``train_grad`` (and ``train_kitti_grad``): one training forward
    and backward of ``model`` (seeded weights, f32, TF32 off) through the
    kernels and through the plain versions on the same batch, held by
    ``compare_training``; kernel-1 launches of the step, forward and input
    gradient apart (``convs`` forward; every sparse conv but conv_input,
    whose input takes no gradient, launches a dX); every sparse conv
    weight gets a gradient; peak memory of each step.  -> (the kernels'
    backward calls: (conv name, features, weight, book, out_valid, inverse
    book, grad_out) each, the kernels' run)."""
    import numpy as np
    import torch
    from q3d_tpu_torch.ops.spconv.modules import SubMConv3d, SparseConv3d
    mk, mp = copy.deepcopy(model), copy.deepcopy(model)
    out = {}
    for impl, m in (("cuda", mk), ("plain", mp)):
        m.set_kernel_impl(impl)
        m.train()
        conv_k.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = m(dict(batch))
        fwd = sum(conv_k.launches.values())
        if impl == "cuda":
            with recording_backward(mk) as recorded:
                res["loss"].backward()
        else:
            res["loss"].backward()
        torch.cuda.synchronize()
        out[impl] = {"loss": float(res["loss"].detach()),
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                     "launches_forward": fwd,
                     "launches_dx": sum(conv_k.launches.values()) - fwd,
                     "launches_by_entry": dict(conv_k.launches),
                     "tb": {k: float(v.detach())
                            for k, v in res["tb_dict"].items()}}
        m.set_kernel_impl(None)
    sparse = [n for n, mod in mk.named_modules()
              if isinstance(mod, (SubMConv3d, SparseConv3d))]
    check(len(sparse) == convs and out["cuda"]["launches_forward"] == convs
          and out["cuda"]["launches_dx"] == max(convs - 1, 0)
          and set(out["cuda"]["launches_by_entry"])
          <= {"q3d_sparse_gather_conv_f32"},
          f"{tag} {config}: kernel-1 launches {out['cuda']}")
    check(out["plain"]["launches_forward"] == out["plain"]["launches_dx"] == 0,
          f"{tag} {config}: plain run launched {out['plain']}")
    check(all(np.isfinite(r["loss"]) for r in out.values()),
          f"{tag} {config}: losses {out}")
    pk = dict(mk.named_parameters())
    for n in sparse:
        g = pk[f"{n}.weight"].grad
        check(g is not None and bool(g.abs().max() > 0),
              f"{tag}: {n}.weight has no gradient")
    check(len(recorded) == convs and sum(r[0] == FIRST_CONV
                                         for r in recorded) == min(convs, 1),
          f"{tag}: {len(recorded)} sparse conv backward calls")
    summary = compare_training(mk, mp, out["cuda"]["loss"],
                               out["plain"]["loss"])
    emit(tag, config=config, batch=int(batch["voxels"].shape[0]),
         dtype="f32", mode=mode(), kernels=out["cuda"], plain=out["plain"],
         sparse_convs=len(sparse), tolerance=TRAIN_TOL,
         peak_covers="three model copies on the card; the kernels' run also "
         "keeps every conv's backward inputs", **summary)
    return recorded, out["cuda"]


def kernel_dx(recorded, flush, mode, tag="kernel_dx", config=CFG.name):
    """Phase ``kernel_dx`` (and ``kernel_dx_second``): kernel 1's f32 entry
    as the input gradient of each sparse conv of a training step (the
    inverse book, the
    weights transposed per tap, the step's real output gradient), against
    its plain version (within 1e-5 of the largest |dX|), timed beside it,
    beside gather + ``torch.matmul`` (the library call of the same
    product) and beside its bound; the weight gradient's torch time
    (``engine.weight_grad``) and the inverse book's build beside them.
    -> totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import engine, gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms", "dw_ms", "inverse_ms")}
    worst = 0.0
    rows = []
    with torch.no_grad():
        for name, f, w, idx, ov, inv, grad_out in recorded:
            if name == FIRST_CONV:
                continue                       # its input takes no gradient
            n, cin = f.shape
            m, k = idx.shape
            cout = w.shape[2]
            g = grad_out.float()
            if ov is not None:
                g = g * ov.reshape(-1, 1).float()
            g = g.contiguous()
            wt = w.transpose(1, 2).contiguous()
            dk = gather_conv.gather_conv_cuda(g, inv, wt)
            dp = gather_conv.gather_conv_plain(g, inv, wt)
            torch.cuda.synchronize()
            err, scale = float((dk - dp).abs().max()), float(dp.abs().max())
            check(err <= 1e-5 * scale, f"{name} dX: kernel vs plain {err} "
                                       f"(scale {scale})")
            worst = max(worst, err)
            present = inv >= 0
            n_present = int(present.sum())
            rows_read = int(torch.unique(inv[present]).numel())
            flat = torch.cat([g, g.new_zeros((1, cout))])
            safe = torch.where(present, inv.long(), m).reshape(-1)
            w2 = wt.reshape(k * cout, cin)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "max_abs_err": err, "scale": scale,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       g, inv, wt), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       g, inv, wt), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.matmul(
                       flat[safe].reshape(n, k * cout), w2), flush=flush),
                   "dw_ms": time_ms(lambda: engine.weight_grad(f, idx, g),
                                    reps=5, flush=flush),
                   "inverse_ms": time_ms(lambda: engine.inverse_book(idx, n),
                                         flush=flush)}
            # the rows of dOut' the inverse book uses, the book, the
            # transposed weights read once, dX written once; the present
            # taps' operations on the CUDA cores (f32)
            nbytes = (rows_read * cout + k * cout * cin + n * cin) * 4 \
                + n * k * 4
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["f32"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit(tag, **row)
            rows.append(row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    emit(f"{tag}_total", config=config, convs=len(rows), dtype="f32",
         mode=mode(), max_abs_err=worst, **totals,
         tolerance="max|k-p| <= 1e-5 * max|p| per conv",
         library="gather of dOut' by the inverse book + torch.matmul",
         dw="engine.weight_grad: per tap, gather + f32 torch.matmul")
    totals["max_abs_err"] = worst
    return totals


def kernel_forward(recorded, flush, mode, tag, config):
    """Phase ``kernel_fwd_second``: kernel 1's f32 entry as each sparse
    conv's forward in a training step, on the operands
    ``recording_backward`` kept (features, book, weights, row mask),
    against its plain version (within 1e-5 of the largest |out|), timed
    beside it, beside gather + ``torch.matmul`` and beside its bound (the
    rows the book uses, the book and the weights read once, the output
    written once; the present taps' f32 operations on the CUDA cores) ->
    totals."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bytes_ms", "ops_ms")}
    worst = 0.0
    with torch.no_grad():
        for name, f, w, idx, ov, _, _ in recorded:
            n, cin = f.shape
            m, k = idx.shape
            cout = w.shape[2]
            yk = gather_conv.gather_conv_cuda(f, idx, w, None, ov)
            yp = gather_conv.gather_conv_plain(f, idx, w, None, ov)
            torch.cuda.synchronize()
            err, scale = float((yk - yp).abs().max()), float(yp.abs().max())
            check(err <= 1e-5 * scale, f"{name} forward: kernel vs plain "
                                       f"{err} (scale {scale})")
            worst = max(worst, err)
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())
            flat = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            w2 = w.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "max_abs_err": err, "scale": scale,
                   "ms": time_ms(lambda: gather_conv.gather_conv_cuda(
                       f, idx, w, None, ov), flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_plain(
                       f, idx, w, None, ov), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch.matmul(
                       flat[safe].reshape(m, k * cin), w2), flush=flush)}
            nbytes = (rows_read * cin + k * cin * cout + m * cout) * 4 \
                + m * k * 4
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["f32"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit(tag, **row)
            for key in totals:
                totals[key] += row[key]
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] \
        else "operations"
    emit(f"{tag}_total", config=config, convs=len(recorded), dtype="f32",
         mode=mode(), max_abs_err=worst, **totals,
         tolerance="max|k-p| <= 1e-5 * max|p| per conv",
         library="gather of the rows by the book + torch.matmul")
    totals["max_abs_err"] = worst
    return totals


def timed_train_model(model, optim, ds, loader, ckpt_dir, conv_k, dev,
                      tag, epochs=TRAIN_EPOCHS):
    """The port's ``train_model`` as a user calls it, with hooks outside it
    that take each step's numbers: host ms (the loader's time, from the
    run's history, with the scene synthesis and the data augmentor timed
    around ``ds.scene`` and ``ds.data_augmentor.forward`` apart), device ms
    between CUDA events that a forward pre-hook and a forward hook on the
    model, each parameter's post-accumulate-grad hook (the last marks the
    backward's end) and a step post-hook on the torch optimizer record:
    forward, backward, and optimizer (both clips and the update); the
    input-gradient kernels' ms and the weight gradients' ms summed (CUDA
    events around each call between the forward's end and the update),
    peak memory, and the memory already allocated when the step starts
    (the model, the optimizer's state, and whatever earlier phases keep on
    the card).  Kernel-1 launch counts are zeroed just before and read just
    after.  Losses finite, every parameter a nonzero gradient (but the
    biases before a train-mode BN, whose gradient is 0).  Emits
    ``<tag>_step`` per step -> (optimizer, steps, launches, run_s)."""
    import numpy as np
    import torch
    from q3d_tpu_torch import train_utils
    from q3d_tpu_torch.ops.spconv import gather_conv
    from torch.optim.optimizer import register_optimizer_step_post_hook

    host = {"scene_ms": 0.0, "augment_ms": 0.0}
    cur, steps = {}, []
    in_bwd, dx_events, dw_events = [False], [], []
    real_cuda, real_wg = gather_conv.gather_conv_cuda, gather_conv.weight_grad
    augmentor = getattr(ds, "data_augmentor", None)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def host_timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += (time.perf_counter() - t0) * 1e3
        return run

    def timed(fn, store, when=lambda: True):
        def run(*a, **kw):
            if not when():
                return fn(*a, **kw)
            start = event()
            out = fn(*a, **kw)
            store.append((start, event()))
            return out
        return run

    def forward_starts(module, args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dx_events.clear()
        dw_events.clear()
        cur.clear()
        cur.update(resident=torch.cuda.memory_allocated() / 2 ** 20,
                   launches=sum(conv_k.launches.values()), host=dict(host),
                   start=event())
        host.update(scene_ms=0.0, augment_ms=0.0)

    def forward_ends(module, args, out):
        cur["forward_end"] = event()
        cur["launches_forward"] = sum(conv_k.launches.values()) \
            - cur["launches"]
        in_bwd[0] = True

    def grad_accumulated(param):
        cur["backward_end"] = event()      # the last parameter's counts

    def optimizer_stepped(optimizer, args, kwargs):
        in_bwd[0] = False
        end = event()
        torch.cuda.synchronize()
        steps.append({
            "step": len(steps) + 1, **cur["host"],
            "forward_ms": cur["start"].elapsed_time(cur["forward_end"]),
            "backward_ms": cur["forward_end"].elapsed_time(
                cur["backward_end"]),
            "optimizer_ms": cur["backward_end"].elapsed_time(end),
            "dx_kernel_ms": sum(a.elapsed_time(b) for a, b in dx_events),
            "dw_ms": sum(a.elapsed_time(b) for a, b in dw_events),
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "resident_mib": cur["resident"],
            "launches_forward": cur["launches_forward"],
            "launches_dx": sum(conv_k.launches.values()) - cur["launches"]
            - cur["launches_forward"]})

    hooks = [model.register_forward_pre_hook(forward_starts),
             model.register_forward_hook(forward_ends),
             register_optimizer_step_post_hook(optimizer_stepped)]
    hooks += [p.register_post_accumulate_grad_hook(grad_accumulated)
              for p in model.parameters() if p.requires_grad]
    ds.scene = host_timed(ds.scene, "scene_ms")
    if augmentor is not None:
        augmentor.forward = host_timed(augmentor.forward, "augment_ms")
    gather_conv.gather_conv_cuda = timed(real_cuda, dx_events,
                                         lambda: in_bwd[0])
    gather_conv.weight_grad = timed(real_wg, dw_events)
    conv_k.launches.clear()
    t0 = time.perf_counter()
    try:
        optimizer, history = train_utils.train_model(
            model, optim, loader, ckpt_dir, total_epochs=epochs, device=dev)
    finally:
        launches = dict(conv_k.launches)
        del ds.scene
        if augmentor is not None:
            del augmentor.forward
        gather_conv.gather_conv_cuda, gather_conv.weight_grad = real_cuda, \
            real_wg
        for h in hooks:
            h.remove()
    run_s = time.perf_counter() - t0
    n_steps = epochs * len(loader)
    check(len(steps) == len(history) == n_steps,
          f"{tag}: {len(steps)} steps, expected {n_steps}")
    for st, h in zip(steps, history):
        # the loader's time before the step (train_model's data meter): the
        # scene's synthesis, the augmentor, then the rest of the data
        # pipeline and the copy to the card
        parts = {k[:-3]: st.pop(k) for k in ("scene_ms", "augment_ms")}
        parts["pipeline"] = h["data_s"] * 1e3 - sum(parts.values())
        st["host_ms"] = parts
        st["loss"] = h["loss"]
        emit(f"{tag}_step", **st)
    check(all(np.isfinite(s["loss"]) for s in steps), f"{tag}: losses")
    zero = train_utils.biases_before_bn(model)
    nograd = [n for n, p in model.named_parameters() if n not in zero and (
        p.grad is None or not bool(p.grad.abs().max() > 0))]
    check(not nograd, f"{tag}: parameters without a gradient {nograd}")
    return optimizer, steps, launches, run_s


def median_after_first(steps):
    """Each step number's median over steps 2.., host ms summed."""
    med = {k: statistics.median(s[k] for s in steps[1:])
           for k in ("forward_ms", "backward_ms", "optimizer_ms",
                     "dx_kernel_ms", "dw_ms", "peak_mib", "resident_mib")}
    med["host_ms"] = statistics.median(sum(s["host_ms"].values())
                                       for s in steps[1:])
    return med


def train_ref(dev, conv_k, mode):
    """Phase ``train_ref``: the port's ``train_model`` at centerpoint_ref's
    width, batch 2, over the config's 8 frames for 2 epochs (8 steps), with
    centerpoint_tiny's OPTIMIZATION block (adam_onecycle, LR 0.003, WD
    0.01, clip 10; the ref config has none), on the kernels, PyTorch's
    default TF32 settings, timed by ``timed_train_model``.  Then a fresh
    model resumes from the run's last checkpoint, and its model and
    optimizer state must equal the trained ones exactly."""
    import shutil
    import numpy as np
    import torch
    from q3d_tpu_torch import train_utils
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    optim = cfg_from_yaml_file(str(TINY_CFG), EDict()).OPTIMIZATION
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=True,
                                     seed=SEED)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    ckpt_dir = ROOT / "output" / "chip_smoke_train_ref"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    optimizer, steps, launches, run_s = timed_train_model(
        model, optim, ds, loader, ckpt_dir, conv_k, dev, "train_ref")
    n_steps = len(steps)
    check(launches == {"q3d_sparse_gather_conv_f32": 41 * n_steps},
          f"train_ref: launches {launches}")

    # resume: a fresh model and optimizer from the newest checkpoint
    fresh = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    opt2, hist2 = train_utils.train_model(fresh, optim, loader, ckpt_dir,
                                          total_epochs=TRAIN_EPOCHS,
                                          device=dev)
    check(not hist2, f"train_ref: resumed run took {len(hist2)} steps")
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        check(torch.equal(a, b), f"train_ref resume: model state {k} differs")
    sa, sb = optimizer.state_dict(), opt2.state_dict()
    check(sa["count"] == sb["count"] == n_steps, "train_ref resume: count")
    for i, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            check(torch.equal(torch.as_tensor(v), torch.as_tensor(
                sb["optimizer"]["state"][i][k]).to(torch.as_tensor(v).device)),
                f"train_ref resume: optimizer state {i}.{k} differs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    med = median_after_first(steps)
    emit("train_ref", config=CFG.name, batch=BATCH, epochs=TRAIN_EPOCHS,
         steps=n_steps, optimization=dict(optim), mode=mode(),
         losses=[s["loss"] for s in steps], launches=launches,
         launches_per_step={"forward": steps[0]["launches_forward"],
                            "dx": steps[0]["launches_dx"]},
         run_s=run_s, median_after_first=med,
         resume="model and optimizer state equal after resume")
    return {"launches_dx": sum(s["launches_dx"] for s in steps),
            "launches_forward": sum(s["launches_forward"] for s in steps),
            "median": med}


def train_tiny(dev, mode):
    """Phase ``train_tiny``: centerpoint_tiny from its seeded init, 8 steps
    of Adam 3e-3 on one batch on the card (the JAX package's
    ``tests/test_training.py`` recipe, on CenterPoint): the loss falls by
    at least 10%."""
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    raw = next(iter(loader))
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device=dev)
    opt = build_optimizer(model.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), TINY_STEPS)
    losses = [float(train_step(model, batch, opt)[0])
              for _ in range(TINY_STEPS)]
    check(losses[-1] < 0.9 * losses[0], f"train_tiny: losses {losses}")
    emit("train_tiny", config=TINY_CFG.name, batch=BATCH, mode=mode(),
         optimizer="adam, lr 3e-3, no weight decay, clip 10", losses=losses,
         fall=1 - losses[-1] / losses[0])


def hold_conv_launches(recorded):
    """Kernel 1 against its plain version on the operands that a training
    step's kernel launches had (``recording_backward``): each sparse conv's
    forward, and its input gradient over the inverse book (not
    conv_input's, whose input takes no gradient), within 1e-5 of the
    largest |value| of each -> {"convs", "forward_worst_rel",
    "dx_worst_rel"}."""
    import torch
    from q3d_tpu_torch.ops.spconv import gather_conv
    worst = {"forward": 0.0, "dx": 0.0}
    with torch.no_grad():
        for name, f, w, idx, ov, inv, grad_out in recorded:
            pairs = {"forward": (f, idx, w, None, ov)}
            if name != FIRST_CONV:
                g = grad_out.float()
                if ov is not None:
                    g = g * ov.reshape(-1, 1).float()
                pairs["dx"] = (g.contiguous(), inv,
                               w.transpose(1, 2).contiguous())
            for what, args in pairs.items():
                k = gather_conv.gather_conv_cuda(*args)
                p = gather_conv.gather_conv_plain(*args)
                err, scale = float((k - p).abs().max()), float(p.abs().max())
                check(err <= 1e-5 * scale, f"{name} {what}: kernel vs plain "
                                           f"{err} (scale {scale})")
                worst[what] = max(worst[what], err / max(scale, 1e-30))
    return {"convs": len(recorded), "forward_worst_rel": worst["forward"],
            "dx_worst_rel": worst["dx"]}


def qat_tiny(dev, conv_k, mode):
    """Phase ``qat_tiny``: the trained centerpoint_tiny fixture (read without
    JAX) under ``centerpoint_recipe()`` (dynamic SmoothQuant fake-quant),
    then QAT steps on the card (f32, TF32 off, ``QAT_OPTIM``): the first
    step through the kernels and through the plain versions held by
    ``compare_training`` at ``QAT_TOL``, and each of the kernels' launches
    in it (forward and input gradient, on the fake-quantized operands it
    had) at 1e-5 of its plain version; every quantized conv's weight
    (the 20 sparse ones and the dense ones the recipe quantizes) gets a
    finite, nonzero gradient; then 3 more steps through the kernels (4 in
    all), losses finite."""
    import numpy as np
    import torch
    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    from q3d_tpu_torch.utils.checkpoint import load_params_from_file
    cfg = cfg_from_yaml_file(str(TINY_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=BATCH, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    load_params_from_file(model, CKPT)
    raw = next(iter(loader))
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device=dev)
    quant_api.quantize_model(model, quant_api.centerpoint_recipe(), batch)
    check(not [n for n, _ in model.named_parameters()
               if "quant" in n or "amax" in n],
          "qat_tiny: a quantizer's state is a parameter")
    quantized = [n for n, m in model.named_modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None]
    n_sparse = sum(n.startswith("backbone_3d") for n in quantized)
    check(n_sparse == 20 and len(quantized) > n_sparse,
          f"qat_tiny: quantized convs {quantized}")
    runs = {}
    for tag in ("cuda", "plain"):
        m = copy.deepcopy(model)
        m.set_kernel_impl(tag)
        opt = build_optimizer(m.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
        conv_k.launches.clear()
        with recording_backward(m) as recorded:
            loss = float(train_step(m, batch, opt)[0])
        runs[tag] = (m, opt, loss, sum(conv_k.launches.values()), recorded)
    mk, opt, loss_k, launches, recorded = runs["cuda"]
    check(launches == 41 and runs["plain"][3] == 0,
          f"qat_tiny: kernel-1 launches {launches} / {runs['plain'][3]}")
    layers = hold_conv_launches(recorded)
    grads = dict(mk.named_parameters())
    for n in quantized:
        g = grads[f"{n}.weight"].grad
        check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
              f"qat_tiny: {n}.weight gradient")
    summary = compare_training(mk, runs["plain"][0], loss_k, runs["plain"][2],
                               qat=True)
    losses = [loss_k] + [float(train_step(mk, batch, opt)[0])
                         for _ in range(QAT_STEPS - 1)]
    check(all(np.isfinite(losses)), f"qat_tiny: losses {losses}")
    emit("qat_tiny", config=TINY_CFG.name, recipe="centerpoint_recipe()",
         batch=BATCH, mode=mode(), quantized_convs={
             "sparse": n_sparse, "dense": len(quantized) - n_sparse},
         launches_first_step=launches, losses=losses, tolerance=QAT_TOL,
         layers=layers, **summary)


# SECOND and PointPillars training at the KITTI configs' width: frames of
# each yaml's BATCH_SIZE_PER_GPU (4), kernel-1 launches a step forward
# (KITTI_CONVS), dX one fewer
KITTI_TRAIN_FRAMES = 8
OVERFIT_STEPS = 8
OVERFIT_OPTIM = {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}


def kitti_train_data(name, dev, frames, seed, augment=False, root=None):
    """The KITTI config ``name`` on a training SyntheticDataset of
    ``frames`` frames at its geometry (FOV-cropped, the 16,000-voxel train
    cap, points shuffled; the yaml's DATA_AUGMENTOR when ``augment``, its
    gt database under ``root``) and the model, seeded -> (cfg, ds, loader,
    model)."""
    import numpy as np
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.kitti_synthetic import kitti_config
    from q3d_tpu_torch.models import build_network
    cfg = kitti_config(name, frames, seed)
    if not augment:
        del cfg.DATA_CONFIG["DATA_AUGMENTOR"]
    np.random.seed(seed)
    ds, loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES,
        batch_size=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), root_path=root,
        training=True, seed=seed)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    return cfg, ds, loader, model


def train_kitti_grad(dev, conv_k, mode):
    """Phase ``train_kitti_grad``: for SECOND and PointPillars at the KITTI
    configs' width, one batch of 4 training frames without augmentation
    (f32, TF32 off): one training forward and backward through the
    kernels and through the plain versions, held by ``train_grad`` (SECOND:
    12 kernel-1 launches forward and 11 as dX; PointPillars launches no
    kernel, and its loss must be finite); then ``train_overfit``: 8 Adam
    steps (LR 3e-3) of each seeded model on that batch, as the JAX
    package's ``tests/test_training.py`` takes them: the last loss below
    0.9 x the first.  -> {name: batch, seeded model, recorded backward
    calls, the kernels' run, losses}."""
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.models import load_data_to_device
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
    out = {}
    for name, convs in KITTI_CONVS.items():
        cfg, ds, loader, model = kitti_train_data(name, dev, 4, SEED)
        raw = next(iter(loader))
        batch = load_data_to_device({k: v for k, v in raw.items()
                                     if k in MODEL_KEYS}, device=dev)
        recorded, run = train_grad(model, batch, conv_k, mode,
                                   "train_kitti_grad",
                                   f"kitti_models/{name}.yaml", convs)
        m = copy.deepcopy(model)
        opt = build_optimizer(m.parameters(), EDict(OVERFIT_OPTIM),
                              OVERFIT_STEPS)
        losses = [float(train_step(m, batch, opt)[0])
                  for _ in range(OVERFIT_STEPS)]
        check(losses[-1] < 0.9 * losses[0],
              f"train_overfit {name}: losses {losses}")
        emit("train_overfit", config=f"kitti_models/{name}.yaml",
             batch=len(raw["gt_boxes"]), mode=mode(),
             voxels=(raw["voxel_num_points"] > 0).sum(1).tolist(),
             voxel_cap=int(raw["voxel_num_points"].shape[1]),
             objects=(raw["gt_boxes"][..., 7] > 0).sum(1).tolist(),
             optimizer="adam, lr 3e-3, no weight decay, clip 10",
             losses=losses, fall=1 - losses[-1] / losses[0])
        del m, opt
        out[name] = {"batch": batch, "model": model, "recorded": recorded,
                     "run": run, "losses": losses}
    return out


def qat_kitti(kitti, conv_k, mode):
    """Phase ``qat_kitti``: each seeded KITTI model under its recipe
    (``second_recipe()``, ``pointpillar_recipe()``: dynamic SmoothQuant
    fake-quant), quantized on its ``train_kitti_grad`` batch, one QAT step
    (``QAT_OPTIM``, f32, TF32 off) through the kernels and through the
    plain versions: the whole step held by ``compare_training`` at
    ``QAT_TOL``, each kernel-1 launch of it (forward and dX, on the
    fake-quantized operands it had) at 1e-5 of its plain version
    (``hold_conv_launches``); every quantized conv's weight and the PFN's
    linear layers get finite, nonzero gradients."""
    import torch
    from q3d_tpu_torch.config import EDict
    from q3d_tpu_torch.optimization import build_optimizer
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.train_utils import train_step
    recipes = {"second": quant_api.second_recipe,
               "pointpillar": quant_api.pointpillar_recipe}
    for name, d in kitti.items():
        convs = KITTI_CONVS[name]
        model = copy.deepcopy(d["model"])
        quant_api.quantize_model(model, recipes[name](), d["batch"])
        check(not [n for n, _ in model.named_parameters()
                   if "quant" in n or "amax" in n],
              f"qat_kitti {name}: a quantizer's state is a parameter")
        quantized = [n for n, m in model.named_modules()
                     if getattr(m, "rule", None) is not None
                     and getattr(m, "weight", None) is not None]
        runs = {}
        for impl in ("cuda", "plain"):
            m = copy.deepcopy(model)
            m.set_kernel_impl(impl)
            opt = build_optimizer(m.parameters(), EDict(QAT_OPTIM), QAT_STEPS)
            conv_k.launches.clear()
            with recording_backward(m) as recorded:
                loss = float(train_step(m, d["batch"], opt)[0])
            runs[impl] = (m, loss, sum(conv_k.launches.values()), recorded)
        mk, loss_k, launches, recorded = runs["cuda"]
        check(launches == max(2 * convs - 1, 0) and runs["plain"][2] == 0,
              f"qat_kitti {name}: kernel-1 launches {launches} / "
              f"{runs['plain'][2]}")
        layers = hold_conv_launches(recorded)
        params = dict(mk.named_parameters())
        watched = [f"{n}.weight" for n in quantized] + [
            n for n in params if n.startswith("vfe.") and n.endswith(
                "linear.weight")]
        for n in watched:
            g = params[n].grad
            check(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0),
                  f"qat_kitti {name}: {n} gradient")
        summary = compare_training(mk, runs["plain"][0], loss_k,
                                   runs["plain"][1], qat=True)
        emit("qat_kitti", config=f"kitti_models/{name}.yaml",
             recipe=f"{recipes[name].__name__}()",
             batch=int(d["batch"]["voxels"].shape[0]), mode=mode(),
             quantized_convs=len(quantized), launches_step=launches,
             tolerance=QAT_TOL, layers=layers, **summary)


def train_kitti(dev, conv_k, nms_k, mode):
    """Phase ``train_kitti``: ``train_model`` for SECOND and PointPillars
    at the KITTI configs' width on 8 synthetic KITTI frames at batch 4, 2
    epochs (4 steps), with each yaml's OPTIMIZATION (adam_onecycle, LR
    0.003, clip 10) and its whole DATA_AUGMENTOR: ``gt_sampling`` reads a
    database that ``write_gt_database`` writes to a temporary directory
    from 8 frames of another seed, then the x flip, the rotation and the
    scaling run as configured.  Timed by ``timed_train_model`` (host,
    forward, backward and optimizer ms a step, peak memory, losses);
    objects placed by gt_sampling per frame and positive anchors per class
    per frame are recorded, and the sampler must place objects in every
    frame, and every class present in a frame must have positives.  Kernel
    launches: SECOND 12 forward and 11 dX a step, PointPillars none, no
    NMS.  -> {name: launches forward / dx, medians}."""
    import tempfile
    import torch
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.datasets.augmentor.database_sampler import \
        DataBaseSampler
    from q3d_tpu_torch.datasets.kitti_synthetic import (kitti_config,
                                                        write_gt_database)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, convs in KITTI_CONVS.items():
            root = Path(tmp) / name
            written = write_gt_database(build_dataloader(
                kitti_config(name, KITTI_TRAIN_FRAMES, SEED + 1).DATA_CONFIG,
                kitti_config(name, 1, SEED).CLASS_NAMES, 1,
                training=False)[0], root)
            cfg, ds, loader, model = kitti_train_data(
                name, dev, KITTI_TRAIN_FRAMES, SEED, augment=True, root=root)
            queue = ds.data_augmentor.data_augmentor_queue
            check([type(q).__name__ if isinstance(q, DataBaseSampler)
                   else q.func.__name__ for q in queue]
                  == ["DataBaseSampler", "random_world_flip",
                      "random_world_rotation", "random_world_scaling"],
                  f"train_kitti {name}: augmentor queue {queue}")
            placed, assigned = [], []
            sampler = queue[0]

            def counting(data_dict=None, sampler=sampler):
                n0 = len(data_dict["gt_boxes"])
                data_dict = sampler(data_dict=data_dict)
                placed.append(len(data_dict["gt_boxes"]) - n0)
                return data_dict
            queue[0] = counting
            head = model.dense_head
            real_assign = head.assign_targets

            def assign(gt_boxes, real_assign=real_assign):
                t = real_assign(gt_boxes)
                classes = torch.arange(1, len(cfg.CLASS_NAMES) + 1,
                                       device=gt_boxes.device)
                assigned.append((
                    (t["box_cls_labels"][:, :, None] == classes).sum(1),
                    (gt_boxes[:, :, 7:8] == classes).sum(1)))
                return t
            head.assign_targets = assign
            nms_k.launches.clear()
            try:
                _, steps, launches, run_s = timed_train_model(
                    model, cfg.OPTIMIZATION, ds, loader,
                    Path(tmp) / f"ckpt_{name}", conv_k, dev, "train_kitti")
            finally:
                del head.assign_targets
            n_steps = len(steps)
            want = {"q3d_sparse_gather_conv_f32": (2 * convs - 1) * n_steps} \
                if convs else {}
            check(launches == want and not any(nms_k.launches.values()),
                  f"train_kitti {name}: launches {launches}, NMS "
                  f"{dict(nms_k.launches)}")
            positives = torch.cat([a for a, _ in assigned]).tolist()
            present = torch.cat([b for _, b in assigned]).tolist()
            check(len(placed) == KITTI_TRAIN_FRAMES * 2 and min(placed) > 0,
                  f"train_kitti {name}: gt_sampling placed {placed}")
            check(all(p > 0 for pos, pres in zip(positives, present)
                      for p, n in zip(pos, pres) if n),
                  f"train_kitti {name}: a class present without positives: "
                  f"{list(zip(present, positives))}")
            med = median_after_first(steps)
            emit("train_kitti", config=f"kitti_models/{name}.yaml",
                 batch=int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU),
                 frames=KITTI_TRAIN_FRAMES, epochs=TRAIN_EPOCHS,
                 steps=n_steps, mode=mode(),
                 optimization={k: cfg.OPTIMIZATION[k] for k in (
                     "OPTIMIZER", "LR", "WEIGHT_DECAY", "GRAD_NORM_CLIP")},
                 augmentor=[c.NAME for c in
                            cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST],
                 gt_database=written, placed_per_frame=placed,
                 classes=list(cfg.CLASS_NAMES),
                 gt_per_class_per_frame=present,
                 positives_per_class_per_frame=positives,
                 losses=[s["loss"] for s in steps], launches=launches,
                 run_s=run_s, median_after_first=med)
            out[name] = {
                "launches_forward": sum(s["launches_forward"] for s in steps),
                "launches_dx": sum(s["launches_dx"] for s in steps),
                "median": med}
            del model
    return out


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "q3d_tpu_torch").is_dir() or not CFG.exists():
        print("chip_smoke: run from a checkout of the repo "
              "(q3d_tpu_torch/ or the configs are missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
    from q3d_tpu_torch.datasets import build_dataloader
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops import kernel_build
    from q3d_tpu_torch.ops.iou3d_nms import candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.ops.spconv import gather_conv
    from q3d_tpu_torch.ops.spconv.modules import SubMConv3d, SparseConv3d
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import modules as sp_modules
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import (TensorQuantizer,
                                                  quantize_with_scale)
    from q3d_tpu_torch.utils.bn_calibration import calibrate_bns

    conv_k, nms_k = gather_conv.KERNEL, nms_mod.KERNEL
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # --------------------------------------------------------------- build
    build_s = kernel_build.build_all([conv_k, nms_k])
    for lib in (conv_k, nms_k):
        lib.lib()
    emit("build", seconds=build_s, libraries=[str(so.relative_to(ROOT))
                                              for lib in (conv_k, nms_k)
                                              for so in lib.so_paths])

    # ---------------------------------------------------------- data/model
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=BATCH, training=False)

    def request(r):
        return make_request(ds, r)

    check(len(ds) == BATCH * REQUESTS, f"dataset has {len(ds)} frames")
    raw0, _, _ = request(0)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)

    def strict_f32(on):
        """TF32 off and deterministic cuDNN in the f32 comparison phases;
        PyTorch's own settings back for the timed bf16 phases."""
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = (False, False, True) if on \
            else defaults

    def mode():
        return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
                "tf32_cudnn": torch.backends.cudnn.allow_tf32,
                "cudnn_deterministic": torch.backends.cudnn.deterministic}

    strict_f32(True)
    batch_f32 = load_data_to_device(raw0, device=dev)

    # BN statistics from the first request (a trained model's BNs match
    # their inputs; random weights with identity BNs fade to constants)
    calibrate_bns(model, batch_f32)

    # ------------------------------------------------------ kernels: conv
    convs, out_ref = record_sparse_convs(model, batch_f32)
    check(len(convs) == 21, f"expected 21 sparse convs, recorded {len(convs)}")

    scratch = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    totals, worst = kernel_conv(convs, flush, mode, CFG.stem)

    # ------------------------------------------------------- kernels: NMS
    head = model.dense_head
    with torch.no_grad():
        sb, ss, sl, sv = head._decode(out_ref["pred_dicts"])
    pre = int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE)
    thresh = float(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_THRESH)
    kc = min(pre, sb.shape[1])
    cand, cand_valid = sb[:, :kc].contiguous(), sv[:, :kc].contiguous()
    # the IoU form (the TPU kernel's own function) on the shared sweep
    iou, iou_valid = candidate_iou(cand, cand_valid)
    keep_k = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="cuda")
    keep_p = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="plain")
    check(torch.equal(keep_k, keep_p), "greedy_nms: ref-decode keep masks differ")
    g = torch.Generator(device=dev).manual_seed(SEED)
    for s, kk in ((6, 128), (6, 1024), (6, 2048)):
        r_iou = torch.rand((s, kk, kk), generator=g, device=dev)
        r_valid = torch.rand((s, kk), generator=g, device=dev) > 0.1
        for th in (0.2, 0.5, 0.9):
            check(torch.equal(nms_mod.greedy_nms(r_iou, r_valid, th, impl="cuda"),
                              nms_mod.greedy_nms(r_iou, r_valid, th, impl="plain")),
                  f"greedy_nms: random K={kk} thresh={th} keep masks differ")

    near_pairs, cand_pairs, near_max_tile = check_boxes_form(
        cand, cand_valid, thresh, "ref decode")
    rng = np.random.RandomState(SEED)
    for kk in (128, 1024):
        rb_ = np.zeros((6, kk, 7), np.float32)      # crowded, with duplicates
        rb_[..., 0:2] = rng.uniform(-0.4, 0.4, (6, kk, 2)) * np.sqrt(kk)
        rb_[..., 3:6] = rng.uniform(0.5, 4.5, (6, kk, 3))
        rb_[..., 6] = rng.uniform(-np.pi, np.pi, (6, kk))
        rb_[:, 10:20] = rb_[:, 0:10]
        rb_[:, 20:30, :6] = rb_[:, 30:40, :6]
        r_boxes = torch.from_numpy(rb_).to(dev)
        r_valid = torch.from_numpy(rng.rand(6, kk) > 0.1).to(dev)
        for th in (0.2, 0.5, 0.9):
            check_boxes_form(r_boxes, r_valid, th, f"random K={kk}")

    # times of the old path's pieces (candidate_iou, then the IoU form) and
    # the new one's, all on the ref decode's candidates, L2 flushed
    corners, areas = nms_mod.bev_corners_areas(cand)
    s, kp, _ = iou.shape
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])

    def bound(terms):
        """The largest term in ms, and its name."""
        name = max(terms, key=terms.get)
        return terms[name], name
    # IoU form: the entries iou[j, i] the function needs (j < i, both valid)
    # read once, one compare each, valid read and keep written once; the
    # sweep's chain of K steps at >= 4 cycles each
    n_cand = iou_valid.sum(1).double()
    pairs = float((n_cand * (n_cand - 1) / 2).sum())
    iou_terms = {"bytes": 1e3 * (pairs * 4 + 2 * s * kp) / HBM_BYTES_PER_S,
                 "operations": 1e3 * pairs / PEAK_OPS_PER_S["f32"],
                 "latency": 1e3 * kp * 4 / (clock_mhz * 1e6)}
    box_terms = boxes_bound(s, kc, cand_pairs, near_pairs, clock_mhz)
    iou_form = {
        "entry": "q3d_greedy_nms", "sets": s, "K": kp,
        "candidate_pairs": pairs,
        "ms": time_ms(lambda: nms_mod.greedy_suppress_cuda(iou, iou_valid,
                                                           thresh), flush=flush),
        "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_plain(
            iou, iou_valid, thresh), reps=5, flush=flush),
        "candidate_iou_ms": time_ms(lambda: candidate_iou(cand, cand_valid),
                                    reps=5, flush=flush),
        **{f"{k}_ms": v for k, v in iou_terms.items()}}
    iou_form["bound_ms"], iou_form["bound_by"] = bound(iou_terms)
    boxes_form = {
        "entry": "q3d_greedy_nms_boxes", "sets": s, "K": kc,
        "candidate_pairs": cand_pairs, "near_pairs": near_pairs,
        "near_pairs_most_in_a_tile": near_max_tile,
        "kept": int(nms_mod.greedy_nms_boxes(cand, cand_valid, thresh).sum()),
        "ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_cuda(
            corners, areas, cand_valid, thresh), flush=flush),
        "with_corners_ms": time_ms(lambda: nms_mod.greedy_nms_boxes(
            cand, cand_valid, thresh, impl="cuda"), flush=flush),
        "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_boxes_plain(
            cand, cand_valid, thresh), reps=5, flush=flush),
        **{f"{k}_ms": v for k, v in box_terms.items()},
        "operations_all_pairs_ms": 1e3 * cand_pairs * IOU_OPS
        / PEAK_OPS_PER_S["f32"]}
    boxes_form["bound_ms"], boxes_form["bound_by"] = bound(box_terms)
    iou_form["kernel_us"] = kernel_device_us(
        lambda: nms_mod.greedy_suppress_cuda(iou, iou_valid, thresh),
        ("nms_iou_mask_kernel", "nms_sweep_kernel"), flush)
    boxes_form["kernel_us"] = kernel_device_us(
        lambda: nms_mod.greedy_suppress_boxes_cuda(corners, areas, cand_valid,
                                                   thresh),
        ("nms_box_pairs_kernel", "nms_box_iou_kernel", "nms_sweep_kernel"),
        flush)
    # the sweep's cost per row of the chain: its device time at three K on
    # random IoU matrices (its code does the same work whatever the data)
    sweep_us = {}
    for kk in (512, 1024, 2048):
        r_iou = torch.rand((s, kk, kk), generator=g, device=dev)
        r_valid = torch.ones((s, kk), dtype=torch.bool, device=dev)
        us = kernel_device_us(lambda: nms_mod.greedy_suppress_cuda(
            r_iou, r_valid, thresh), ("nms_sweep_kernel",), flush)
        sweep_us[kk] = us if isinstance(us, str) else us["nms_sweep_kernel"]
    if not any(isinstance(v, str) for v in sweep_us.values()):
        iou_form["sweep_us_by_K"] = sweep_us
        iou_form["sweep_cycles_per_row"] = (sweep_us[2048] - sweep_us[512]) \
            * clock_mhz / (2048 - 512)
    old_path_ms = iou_form["candidate_iou_ms"] + iou_form["ms"]
    emit("kernel_nms", form="iou", **iou_form, kept=int(keep_k.sum()),
         max_abs_err=0, tolerance="keep masks exactly equal (ref decode + "
         "random K=128/1024/2048)", clock_max_sm_mhz=clock_mhz)
    emit("kernel_nms", form="boxes", **boxes_form, max_abs_err=0,
         old_path_ms=old_path_ms, under_old_path=boxes_form["ms"] < old_path_ms,
         tolerance="keep masks exactly equal, IoU bit-equal at every "
         "evaluated pair, plain IoU exactly 0 at every skipped needed pair "
         "(ref decode + random K=128/1024 x thresh 0.2/0.5/0.9)",
         clock_max_sm_mhz=clock_mhz)
    check(boxes_form["ms"] < old_path_ms,
          f"boxes form {boxes_form['ms']} ms is not under candidate_iou + the "
          f"IoU form, {old_path_ms} ms")

    # -------------------------------------------------------------- serving
    strict_f32(False)
    conv_k.launches.clear()
    nms_k.launches.clear()
    per_request = []
    for r in range(REQUESTS):
        raw, scene_ms, vox_ms = request(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = load_data_to_device(raw, device=dev, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            out = model(batch)
        n_valid = out["final_valid"].sum(dim=1).tolist()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"request {r}: non-finite outputs")
        check(out["final_boxes"].shape == (BATCH, 3 * 83, 9),
              f"request {r}: final_boxes shape {tuple(out['final_boxes'].shape)}")
        per_request.append({"request": r, "frames": [2 * r, 2 * r + 1],
                            "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                            "device_forward_ms": fwd_ms,
                            "valid_detections": n_valid})
        emit("serving_request", **per_request[-1])
    launches = {"sparse_gather_conv": sum(conv_k.launches.values()),
                "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
                "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"]}
    check(launches["sparse_gather_conv"] == 21 * REQUESTS
          and launches["greedy_nms_boxes"] == REQUESTS
          and launches["greedy_nms_iou"] == 0,
          f"main path launches {launches}")
    emit("serving", config=CFG.name, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))

    # ------------------------------------------------------------- stages
    # where one bf16 forward's time goes: CUDA events around each stage of
    # the last request, median of 5 forwards
    emit("stages", dtype="bf16", batch=BATCH, mode=mode(),
         ms=stage_times(model, batch), sparse_conv_kernels_ms=totals["ms"])

    # --------------------------------------------------- whole-model check
    strict_f32(True)
    with torch.no_grad():
        model.set_kernel_impl("cuda")
        out_k = model(dict(batch_f32))
        model.set_kernel_impl("plain")
        out_p = model(dict(batch_f32))
        model.set_kernel_impl(None)
    maps = {"spatial_features": (out_k["spatial_features"],
                                 out_p["spatial_features"]),
            "spatial_features_2d": (out_k["spatial_features_2d"],
                                    out_p["spatial_features_2d"])}
    for h, (pk, pp) in enumerate(zip(out_k["pred_dicts"], out_p["pred_dicts"])):
        for key in pk:
            maps[f"head{h}.{key}"] = (pk[key], pp[key])
    map_err = {}
    for key, (a, b) in maps.items():
        err, mag = float((a - b).abs().max()), float(b.abs().max())
        map_err[key] = err
        check(err <= 1e-4 * max(1.0, mag),
              f"model f32 {key}: kernels vs plain max err {err} (scale {mag})")
    # identical candidates through both NMS paths: equal keep masks and
    # equal final detections
    with torch.no_grad():
        cand = head._decode(out_k["pred_dicts"])
        iou, iou_valid = candidate_iou(cand[0][:, :kc], cand[3][:, :kc])
        check(torch.equal(nms_mod.greedy_nms(iou, iou_valid, thresh, impl="cuda"),
                          nms_mod.greedy_nms(iou, iou_valid, thresh, impl="plain")),
              "model f32: NMS keep masks (IoU form) differ on identical "
              "candidates")
        bx, bv = cand[0][:, :kc].contiguous(), cand[3][:, :kc].contiguous()
        check(torch.equal(nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="cuda"),
                          nms_mod.greedy_nms_boxes(bx, bv, thresh, impl="plain")),
              "model f32: NMS keep masks (boxes form) differ on identical "
              "candidates")
        finals = []
        for impl in ("cuda", "plain"):
            head.kernel_impl = impl
            bd = {}
            head._nms(bd, *cand)
            finals.append(bd)
        head.kernel_impl = None
    for key in ("final_boxes", "final_scores", "final_labels", "final_valid"):
        check(torch.equal(finals[0][key], finals[1][key]),
              f"model f32: {key} differs between NMS kernel and plain")
    # end to end: every valid detection of one run has a partner in the
    # other (same label, box within 1e-3, score within 1e-4); a partner can
    # be missing only where near-equal scores reorder the greedy sweep
    matched, total = 0, 0
    for a, b in ((out_k, out_p), (out_p, out_k)):
        for i in range(BATCH):
            va, vb = a["final_valid"][i], b["final_valid"][i]
            ba, bb = a["final_boxes"][i][va], b["final_boxes"][i][vb]
            la, lb = a["final_labels"][i][va], b["final_labels"][i][vb]
            sa, sb_ = a["final_scores"][i][va], b["final_scores"][i][vb]
            total += len(ba)
            if len(ba) == 0 or len(bb) == 0:
                continue
            ok = ((ba[:, None, :] - bb[None, :, :]).abs().amax(-1) <= 1e-3) \
                & (la[:, None] == lb[None, :]) \
                & ((sa[:, None] - sb_[None, :]).abs() <= 1e-4)
            matched += int(ok.any(1).sum())
    frac = matched / max(total, 1)
    check(frac >= 0.99, f"model f32: only {matched}/{total} detections matched")
    emit("model_check", dtype="f32", mode=mode(), map_max_abs_err=map_err,
         map_tolerance="max|k-p| <= 1e-4 * max(1, max|p|)",
         nms_identical_inputs="keep masks (both forms) and final detections "
         "(head._nms through the kernel and the plain version) equal",
         detections_matched=matched, detections=total, matched_fraction=frac)
    strict_f32(False)

    # ========================================================= int8 deploy
    # the bench recipe (every sparse conv and BEV conv int8 with residency,
    # the head bf16), calibrated with method "max" on the first request
    # given twice, as the JAX package's bench calibrates
    batch0 = load_data_to_device(raw0, device=dev, compute_dtype=torch.bfloat16)

    def int8_model(recipe):
        m8 = copy.deepcopy(model)
        quant_api.prepare_int8_deploy(m8, [batch0, batch0],
                                      recipe_kwargs=recipe)
        return m8
    t0 = time.perf_counter()
    bench8 = int8_model(BENCH_RECIPE)
    calib_s = time.perf_counter() - t0

    # one forward with the fused entry's and the dense int8 conv's
    # arguments recorded, call by call, under their module's name
    fused_calls, dense_calls, current = [], [], [None]
    names8 = {m: n for n, m in bench8.named_modules()}
    real_rq, real_i8 = sp_modules.sparse_gather_conv_requant, \
        dense_layers.int8_conv2d

    def note(mod, args):
        current[0] = names8[mod]

    def rec_rq(*args, **kw):
        fused_calls.append((current[0], args, kw))
        return real_rq(*args, **kw)

    def rec_i8(*args, **kw):
        dense_calls.append((current[0], args, kw))
        return real_i8(*args, **kw)
    hooks = [m.register_forward_pre_hook(note) for m in bench8.modules()
             if hasattr(m, "QUANT_KIND")]
    sp_modules.sparse_gather_conv_requant = rec_rq
    dense_layers.int8_conv2d = rec_i8
    try:
        with torch.no_grad():
            bench8(dict(batch0))
    finally:
        sp_modules.sparse_gather_conv_requant = real_rq
        dense_layers.int8_conv2d = real_i8
        for h in hooks:
            h.remove()
    check(len(fused_calls) == 21,
          f"bench int8: {len(fused_calls)} fused sparse convs, expected 21")
    check(len(dense_calls) == 12,
          f"bench int8: {len(dense_calls)} int8 BEV convs, expected 12")

    # ----------------------------------------- kernels: the fused s8 entry
    rq_totals = {k: 0.0 for k in ("ms", "unfused_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bytes_ms", "ops_ms")}
    with torch.no_grad():
        for name, args, kw in fused_calls:
            kw = {k: v for k, v in kw.items() if k != "impl"}
            f, idx, wq, osc, kf, bf, s_rq = args
            n, cin = f.shape
            m, k = idx.shape
            cout = wq.shape[2]
            ident = kw["identity"]
            q_k = gather_conv.gather_conv_requant_cuda(*args, **kw)
            q_p = gather_conv.gather_conv_requant_plain(*args, **kw)
            torch.cuda.synchronize()
            ndiff = int((q_k != q_p).sum())
            check(ndiff == 0, f"{name} fused s8 requant: {ndiff} of "
                              f"{q_k.numel()} int8 outputs differ from plain")
            present = (idx >= 0) & (idx < n)
            n_present = int(present.sum())
            rows_read = int(torch.unique(idx[present]).numel())

            def unfused():
                y = gather_conv.gather_conv_cuda(f, idx, wq, osc,
                                                 kw["out_valid"])
                return quantize_with_scale(gather_conv.epilogue_f32(
                    y, kf, bf, kw["row_valid"], ident, kw["identity_scale"]), s_rq)
            flatq = torch.cat([f, f.new_zeros((1, cin))])
            safe = torch.where(present, idx.long(), n).reshape(-1)
            wq2 = wq.reshape(k * cin, cout)
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present,
                   "identity": None if ident is None else str(ident.dtype),
                   "ms": time_ms(lambda: gather_conv.gather_conv_requant_cuda(
                       *args, **kw), flush=flush),
                   "unfused_ms": time_ms(unfused, flush=flush),
                   "plain_ms": time_ms(lambda: gather_conv.gather_conv_requant_plain(
                       *args, **kw), reps=5, flush=flush),
                   "library_ms": time_ms(lambda: torch._int_mm(
                       flatq[safe].reshape(m, k * cin), wq2), flush=flush)}
            # inputs read once (the rows the book uses, the book, the
            # weights, the identity, the scale/fold vectors, the masks), the
            # s8 output written once; the present taps' operations
            nbytes = rows_read * cin + m * k * 4 + k * cin * cout + m * cout \
                + (0 if ident is None else m * cout * ident.element_size()) \
                + 3 * 4 * cout + 2 * m
            row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
            row["ops_ms"] = 1e3 * 2.0 * n_present * cin * cout \
                / PEAK_OPS_PER_S["s8"]
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            emit("kernel_conv_s8_requant", **row)
            for key in rq_totals:
                rq_totals[key] += row[key]
    rq_totals["bound_by"] = "bytes" if rq_totals["bytes_ms"] \
        >= rq_totals["ops_ms"] else "operations"
    emit("kernel_conv_s8_requant_total", convs=len(fused_calls), **rq_totals,
         calibration_s=calib_s, recipe="bench", mode=mode(),
         tolerance="bit-exact (int8 outputs equal)", max_abs_err=0,
         unfused="s8 entry (f32 rows) + the torch epilogue and requant",
         library="gather + torch._int_mm (the conv without its epilogue)")

    # --------------------------------------- the dense int8 conv (_int_mm)
    i8_rows = []
    with torch.no_grad():
        for name, args, kw in dense_calls:
            x, w8, stride, padding = args
            o_k = real_i8(x, w8, stride, padding, impl="cuda")
            o_p = real_i8(x, w8, stride, padding, impl="plain")
            torch.cuda.synchronize()
            check(torch.equal(o_k, o_p),
                  f"{name} int8_conv2d: _int_mm s32 != the exact product")
            a, _ = dense_layers._patches(x, w8.shape[2:], stride, padding)
            wm = w8.permute(0, 2, 3, 1).reshape(w8.shape[0], -1)
            xb = x.to(torch.bfloat16).contiguous()
            wb = w8.to(torch.bfloat16)
            mm, kk_, nn_ = a.shape[0], a.shape[1], wm.shape[0]
            row = {"conv": name, "x": list(x.shape), "w": list(w8.shape),
                   "stride": list(stride), "gemm_mkn": [mm, kk_, nn_],
                   "ms": time_ms(lambda: real_i8(x, w8, stride, padding,
                                                 impl="cuda"), flush=flush),
                   "int_mm_ms": time_ms(lambda: torch._int_mm(a, wm.t()),
                                        flush=flush),
                   "cudnn_bf16_ms": time_ms(lambda: torch.nn.functional.conv2d(
                       xb, wb, None, stride, padding), flush=flush)}
            nbytes = x.numel() + w8.numel() + 4 * mm * nn_
            row["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 2.0 * mm
                                        * kk_ * nn_ / PEAK_OPS_PER_S["s8"])
            emit("int8_conv2d", **row)
            i8_rows.append(row)
    emit("int8_conv2d_total", convs=len(i8_rows), mode=mode(),
         tolerance="s32 exactly equal to the plain product",
         **{k: sum(r[k] for r in i8_rows)
            for k in ("ms", "int_mm_ms", "cudnn_bf16_ms", "bound_ms")})

    # ------------------------------------------------------ serving, int8
    clear_launches(conv_k, nms_k)
    per_request = []
    for r in range(REQUESTS):
        raw, scene_ms, vox_ms = request(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = load_data_to_device(raw, device=dev, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            out = bench8(batch)
        n_valid = out["final_valid"].sum(dim=1).tolist()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(out[k].float()).all() for k in
                  ("spatial_features_2d", "final_boxes", "final_scores")),
              f"int8 request {r}: non-finite outputs")
        check(out["final_boxes"].shape == (BATCH, 3 * 83, 9),
              f"int8 request {r}: final_boxes shape "
              f"{tuple(out['final_boxes'].shape)}")
        per_request.append({"request": r, "frames": [2 * r, 2 * r + 1],
                            "scene_ms": scene_ms, "voxelize_ms": vox_ms,
                            "device_forward_ms": fwd_ms,
                            "valid_detections": n_valid})
        emit("serving_int8_request", **per_request[-1])
    launches8 = {
        "sparse_gather_conv_s8_requant": conv_k.launches[gather_conv.REQUANT_ENTRY],
        "sparse_gather_conv_other": sum(conv_k.launches.values())
        - conv_k.launches[gather_conv.REQUANT_ENTRY],
        "int_mm_conv2d": dense_layers.INT_MM_CALLS["int8_conv2d"],
        "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
        "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"]}
    check(launches8 == {"sparse_gather_conv_s8_requant": 21 * REQUESTS,
                        "sparse_gather_conv_other": 0,
                        "int_mm_conv2d": 12 * REQUESTS,
                        "greedy_nms_boxes": REQUESTS, "greedy_nms_iou": 0},
          f"int8 main path launches {launches8}")
    # bf16 and int8 forwards of the same batch in turns, host clock around
    # a forward that ends in a synchronize
    fwd = {"bf16": [], "int8": []}
    with torch.no_grad():
        for _ in range(6):
            for tag, mdl in (("bf16", model), ("int8", bench8)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mdl(dict(batch))
                torch.cuda.synchronize()
                fwd[tag].append((time.perf_counter() - t0) * 1e3)
    fwd_med = {k: statistics.median(v[1:]) for k, v in fwd.items()}
    emit("serving_int8", config=CFG.name, batch=BATCH, recipe="bench",
         requests=REQUESTS, launches=launches8, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]),
         in_turns_forward_ms=fwd_med,
         int8_vs_bf16=fwd_med["bf16"] / fwd_med["int8"])
    st8 = stage_times(bench8, batch)
    st16 = stage_times(model, batch)
    emit("stages_int8", batch=BATCH, recipe="bench", mode=mode(),
         ms_int8=st8, ms_bf16=st16,
         bf16_over_int8={k: st16[k] / st8[k] for k in st8 if st8[k] > 0},
         fused_conv_kernels_ms=rq_totals["ms"])
    emit("forward_trace", batch=BATCH, recipe="bench", mode=mode(),
         bf16=forward_trace(model, batch), int8=forward_trace(bench8, batch))

    # --------------------------------------- whole-model check, int8 path
    # one request through the kernels and through the plain versions with
    # one set of calibrated scales, under both recipes: every int8 feature
    # map a residency layer emits, spatial_features and the detections
    # equal.  The entry recipe keeps conv_input float, and a float conv
    # equals its plain version exactly only in f32 (bf16: within one
    # rounding), so its request is the f32 one.
    strict_f32(True)
    recipes = {"bench": (bench8, batch0), "entry": (int8_model({}), batch_f32)}
    model_int8 = {}
    for tag, (m8, req) in recipes.items():
        grabbed = {"cuda": [], "plain": []}
        impl_now = [None]

        def grab(mod, args, out):
            t = out.features if hasattr(out, "features") else out[0]
            if t.dtype == torch.int8:
                grabbed[impl_now[0]].append((names_q[mod], t))
        names_q = {mm: n for n, mm in m8.named_modules()}
        sparse_names = {n for mm, n in names_q.items()
                        if isinstance(mm, (SubMConv3d, SparseConv3d))}
        watched = [mm for mm in m8.modules()
                   if isinstance(mm, (SubMConv3d, SparseConv3d))
                   or (isinstance(mm, TensorQuantizer)
                       and not names_q[mm].endswith("weight_quant"))]
        hooks = [mm.register_forward_hook(grab) for mm in watched]
        outs, ms, fused = {}, {}, {}
        try:
            with torch.no_grad():
                for impl in ("cuda", "plain"):
                    impl_now[0] = impl
                    m8.set_kernel_impl(impl)
                    fused0 = conv_k.launches[gather_conv.REQUANT_ENTRY]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs[impl] = m8(dict(req))
                    torch.cuda.synchronize()
                    ms[impl] = (time.perf_counter() - t0) * 1e3
                    fused[impl] = conv_k.launches[gather_conv.REQUANT_ENTRY] \
                        - fused0
        finally:
            m8.set_kernel_impl(None)
            for h in hooks:
                h.remove()
        n_sparse = 21 if tag == "bench" else 20      # entry: conv_input float
        check(fused == {"cuda": n_sparse, "plain": 0},
              f"model int8 {tag}: fused entry launches {fused}")
        gk, gp = grabbed["cuda"], grabbed["plain"]
        check(len(gk) == len(gp) > 0 and [n for n, _ in gk] == [n for n, _ in gp],
              f"model int8 {tag}: int8 maps {len(gk)} vs {len(gp)}")
        bad = [n for (n, a), (_, b) in zip(gk, gp) if not torch.equal(a, b)]
        check(not bad, f"model int8 {tag}: int8 features differ at {bad[:5]}")
        for key in ("spatial_features", "final_boxes", "final_scores",
                    "final_labels", "final_valid"):
            check(torch.equal(outs["cuda"][key], outs["plain"][key]),
                  f"model int8 {tag}: {key} differs between kernels and plain")
        model_int8[tag] = {
            "request_dtype": str(req["voxels"].dtype),
            "fused_launches": fused["cuda"],
            "int8_maps_equal": len(gk),
            "sparse_int8_maps": sum(n in sparse_names for n, _ in gk),
            "valid_detections": outs["cuda"]["final_valid"].sum(1).tolist(),
            "forward_ms": ms}
    emit("model_int8", recipes=model_int8, mode=mode(), batch=BATCH,
         equal="every int8 map a residency layer emits, spatial_features and "
               "final boxes/scores/labels/valid, kernels vs plain (exact)")
    strict_f32(False)

    # ============================== int8 deploy without residency
    # the PTQ driver's and tools/test.py's recipes: dynamic, SmoothQuant and
    # static, each sparse conv on kernel 1's unfused s8 entry
    deploy, s8_calls = deploy_int8(model, batch0, batch_f32, conv_k, nms_k,
                                   mode, strict_f32, flush)
    s8_totals = kernel_conv_s8(s8_calls, flush, mode)

    # ================================= the accuracy gates and fake-quant
    # both in f32 with TF32 off, as the reference's eval_one_epoch runs
    strict_f32(True)
    gates = eval_gates(dev, conv_k, nms_k, mode)
    fakequant_ref(model, batch_f32, conv_k, nms_k, mode, flush)
    driver = driver_tiny(conv_k, nms_k, mode, gates["fp32"]["cuda"]["NDS"])
    strict_f32(False)

    def per_recipe(key):
        return {tag: g["cuda"]["launches"][key] for tag, g in gates.items()}

    # ============================= SECOND and PointPillars at KITTI width
    kitti = {name: kitti_model(name, dev, conv_k, nms_k, mode, strict_f32)
             for name in KITTI_CONVS}
    strict_f32(True)
    second_totals, second_worst = kernel_conv(kitti["second"]["convs"], flush,
                                              mode, "second")
    strict_f32(False)
    nms_wide = kernel_nms_wide(kitti, flush, mode, clock_mhz)
    recipes_kitti(kitti, conv_k, nms_k, mode, strict_f32)
    kitti_launches = {name: {"sparse_gather_conv": sum(
        k_["launches"][e] for e in k_["launches"]
        if e.startswith("sparse_gather_conv")),
        "greedy_nms_boxes": k_["launches"]["greedy_nms_boxes"]}
        for name, k_ in kitti.items()}

    # ============================================================ training
    # the trainer: one step's gradients through the kernels against the
    # plain versions (f32, TF32 off), kernel 1 as the input gradient, QAT
    # on the trained tiny fixture; then the tiny model learning, and
    # train_model at ref width (the slice's main path; PyTorch's TF32
    # defaults)
    # a ref training step through both routes needs ~23 GB: let go of the
    # inference phases' models and recorded conv inputs first
    n_s8_convs = len(s8_calls)
    del bench8, recipes, m8, fused_calls, dense_calls, s8_calls, kitti
    strict_f32(True)
    recorded, _ = train_grad(model, batch_f32, conv_k, mode)
    dx_totals = kernel_dx(recorded, flush, mode)
    del recorded
    qat_tiny(dev, conv_k, mode)
    strict_f32(False)
    train_tiny(dev, mode)
    trained = train_ref(dev, conv_k, mode)

    # ============================= SECOND and PointPillars training
    # one step's gradients through the kernels against the plain versions
    # and SECOND's dX (f32, TF32 off), QAT; then train_model with the data
    # augmentor (the slice's main path; PyTorch's TF32 defaults)
    strict_f32(True)
    kitti_train = train_kitti_grad(dev, conv_k, mode)
    recorded = kitti_train["second"].pop("recorded")
    fwd_second = kernel_forward(recorded, flush, mode, "kernel_fwd_second",
                                "kitti_models/second.yaml")
    dx_second = kernel_dx(recorded, flush, mode, "kernel_dx_second",
                          "kitti_models/second.yaml")
    del recorded
    qat_kitti(kitti_train, conv_k, mode)
    strict_f32(False)
    del kitti_train
    kitti_trained = train_kitti(dev, conv_k, nms_k, mode)

    # ---------------------------------------------------------- kernels line
    kernels = [
        {"name": "sparse_gather_conv", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "launches": launches["sparse_gather_conv"],
         "max_abs_err": worst["bf16"], "ms": totals["ms"],
         "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
         "bound_by": "bytes" if totals["bytes_ms"] >= totals["ops_ms"]
         else "operations", "library_ms": totals["library_ms"],
         "design": CONV_DESIGN,
         "eval_launches_f32_entry": per_recipe("sparse_gather_conv_f32"),
         "launches_second": kitti_launches["second"]["sparse_gather_conv"],
         "second": {"ms": second_totals["ms"],
                    "plain_ms": second_totals["plain_ms"],
                    "bound_ms": second_totals["bound_ms"],
                    "library_ms": second_totals["library_ms"],
                    "max_abs_err": second_worst["bf16"],
                    "times_cover": "one SECOND bf16 forward (12 convs)"},
         "checks": "passed", "times_cover": "one bf16 forward (21 convs)"},
        {"name": "sparse_gather_conv_dx", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "the input gradient of every sparse conv but conv_input, "
                "over the inverse book, weights transposed per tap",
         "launches": trained["launches_dx"],
         "forward_launches": trained["launches_forward"],
         "max_abs_err": dx_totals["max_abs_err"], "ms": dx_totals["ms"],
         "plain_ms": dx_totals["plain_ms"], "bound_ms": dx_totals["bound_ms"],
         "bound_by": dx_totals["bound_by"],
         "library_ms": dx_totals["library_ms"],
         "dw_torch_ms": dx_totals["dw_ms"],
         "inverse_book_ms": dx_totals["inverse_ms"], "checks": "passed",
         "times_cover": "one f32 ref training step's 20 input gradients; "
                        "launches: train_model's 8 steps"},
        {"name": "sparse_gather_conv_f32_second_train", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "SECOND training (kitti_models/second.yaml, batch 4): the "
                "forward of its 12 sparse convs",
         "launches": kitti_trained["second"]["launches_forward"],
         "max_abs_err": fwd_second["max_abs_err"], "ms": fwd_second["ms"],
         "plain_ms": fwd_second["plain_ms"],
         "bound_ms": fwd_second["bound_ms"],
         "bound_by": fwd_second["bound_by"],
         "library_ms": fwd_second["library_ms"], "checks": "passed",
         "times_cover": "one f32 SECOND training step's 12 conv forwards; "
                        "launches: train_kitti's 4 steps"},
        {"name": "sparse_gather_conv_dx_second", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_f32",
         "use": "SECOND training (kitti_models/second.yaml, batch 4): the "
                "input gradient of every sparse conv but conv_input",
         "launches": kitti_trained["second"]["launches_dx"],
         "forward_launches": kitti_trained["second"]["launches_forward"],
         "max_abs_err": dx_second["max_abs_err"], "ms": dx_second["ms"],
         "plain_ms": dx_second["plain_ms"], "bound_ms": dx_second["bound_ms"],
         "bound_by": dx_second["bound_by"],
         "library_ms": dx_second["library_ms"],
         "dw_torch_ms": dx_second["dw_ms"],
         "inverse_book_ms": dx_second["inverse_ms"], "checks": "passed",
         "times_cover": "one f32 SECOND training step's 11 input gradients; "
                        "launches: train_kitti's 4 steps"},
        {"name": "sparse_gather_conv_s8_requant", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": gather_conv.REQUANT_ENTRY,
         "launches": launches8["sparse_gather_conv_s8_requant"],
         "max_abs_err": 0.0, "ms": rq_totals["ms"],
         "plain_ms": rq_totals["plain_ms"], "bound_ms": rq_totals["bound_ms"],
         "bound_by": rq_totals["bound_by"],
         "library_ms": rq_totals["library_ms"],
         "unfused_ms": rq_totals["unfused_ms"],
         "eval_launches": per_recipe("sparse_gather_conv_s8_requant"),
         "checks": "passed",
         "times_cover": "one int8 forward, bench recipe (21 residency convs)"},
        {"name": "sparse_gather_conv_s8", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/sparse_gather_conv.cu",
         "replaces": "q3d_tpu/ops/spconv/pallas_conv.py:274",
         "entry": "q3d_sparse_gather_conv_s8",
         "launches": deploy["dynamic"]["launches"]["sparse_gather_conv_s8"],
         "max_abs_err": 0.0, "ms": s8_totals["ms"],
         "plain_ms": s8_totals["plain_ms"], "bound_ms": s8_totals["bound_ms"],
         "bound_by": s8_totals["bound_by"],
         "library_ms": s8_totals["library_ms"],
         "launches_by_recipe": {tag: d["launches"]["sparse_gather_conv_s8"]
                                for tag, d in deploy.items()},
         "driver_launches": {tag: d["launches"]["sparse_gather_conv_s8"]
                             for tag, d in driver.items()},
         "checks": "passed",
         "times_cover": "one int8 forward, int8_deploy_recipe() "
                        f"({n_s8_convs} convs)"},
        {"name": "greedy_nms", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
         "entry": "q3d_greedy_nms_boxes",
         "launches": launches["greedy_nms_boxes"], "max_abs_err": 0.0,
         "ms": boxes_form["ms"], "plain_ms": boxes_form["plain_ms"],
         "bound_ms": boxes_form["bound_ms"], "bound_by": boxes_form["bound_by"],
         "library_ms": None, "checks": "passed",
         "eval_launches": per_recipe("greedy_nms_boxes"),
         "times_cover": f"one forward's NMS from BEV corners ({s} sets, "
                        f"K={kc}); the IoU form from the padded IoU matrix "
                        f"(K={kp})",
         "launches_kitti": {n: v["greedy_nms_boxes"]
                            for n, v in kitti_launches.items()},
         "k4096": {n: {k: r[k] for k in ("sets", "K", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                   for n, r in nms_wide.items()},
         "entries": [
             {"entry": f["entry"], "launches": launches[key], "ms": f["ms"],
              "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
              "bound_by": f["bound_by"]}
             for f, key in ((boxes_form, "greedy_nms_boxes"),
                            (iou_form, "greedy_nms_iou"))]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
