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
 10. the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises and exits nonzero without the last line.  Without
CUDA, or outside a checkout of the repo, it exits 1 and prints no result.
``USE_APPROX_TOPK`` in the config is ignored: the port's top-K is exact.
"""

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
    ``batch``, median of ``reps`` -> {stage: ms}.  The head's decode and NMS
    are methods, not modules, so they are timed through instance attributes
    that shadow them for the run."""
    import torch
    head = model.dense_head
    stages = {"vfe": model.vfe, "backbone_3d": model.backbone_3d,
              "map_to_bev": model.map_to_bev_module,
              "backbone_2d": model.backbone_2d,
              "head_convs": [head.shared_conv, head.shared_requant,
                             *head.heads_list],
              "dense_head": head}
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
    head._decode = timed("decode", head._decode)
    head._nms = timed("nms", head._nms)
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
        del head._decode, head._nms
    stage_ms = {k: statistics.median(v) for k, v in stage_ms.items()}
    stage_ms["decode_nms"] = stage_ms["dense_head"] - stage_ms["head_convs"]
    return stage_ms


def kernel_launches(conv_k, nms_k):
    """Launch counts of both kernels, by entry."""
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.ops.spconv import gather_conv
    return {"sparse_gather_conv_f32": conv_k.launches["q3d_sparse_gather_conv_f32"],
            "sparse_gather_conv_s8_requant":
                conv_k.launches[gather_conv.REQUANT_ENTRY],
            "sparse_gather_conv_other": sum(conv_k.launches.values())
            - conv_k.launches["q3d_sparse_gather_conv_f32"]
            - conv_k.launches[gather_conv.REQUANT_ENTRY],
            "greedy_nms_boxes": nms_k.launches["q3d_greedy_nms_boxes"],
            "greedy_nms_iou": nms_k.launches["q3d_greedy_nms"],
            "int_mm_conv2d": dense_layers.INT_MM_CALLS["int8_conv2d"]}


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
        runs = {}
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
             plain_vs_kernels=row["plain_vs_kernels"])
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
    from q3d_tpu_torch.datasets.synthetic_dataset import make_scene
    from q3d_tpu_torch.models import build_network, load_data_to_device
    from q3d_tpu_torch.ops import kernel_build
    from q3d_tpu_torch.ops.iou3d_nms import boxes_iou_bev, candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.ops.spconv import gather_conv
    from q3d_tpu_torch.ops.spconv.modules import (SubMConv3d, SparseConv3d,
                                                  SparseBatchNorm,
                                                  subm_cache_key,
                                                  down_cache_key)
    from q3d_tpu_torch.models import layers as dense_layers
    from q3d_tpu_torch.models.layers import BatchNorm
    from q3d_tpu_torch.ops.spconv import modules as sp_modules
    from q3d_tpu_torch.quant import api as quant_api
    from q3d_tpu_torch.quant.tensor_quant import (TensorQuantizer,
                                                  quantize_with_scale)

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
        """Frames 2r, 2r+1 -> (numpy batch, scene ms, voxelize ms)."""
        frames, scene_ms, vox_ms = [], 0.0, 0.0
        for j in range(r * BATCH, (r + 1) * BATCH):
            t0 = time.perf_counter()
            rng = np.random.RandomState(ds.base_seed + j)
            points, boxes, names = make_scene(rng, ds.point_cloud_range,
                                              **ds.scene_kwargs)
            t1 = time.perf_counter()
            frames.append(ds.prepare_data({"points": points, "gt_boxes": boxes,
                                           "gt_names": names, "frame_id": j}))
            t2 = time.perf_counter()
            scene_ms += (t1 - t0) * 1e3
            vox_ms += (t2 - t1) * 1e3
        return ds.collate_batch(frames), scene_ms, vox_ms

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
    def calibrate(mod, args):
        x = args[0]
        if isinstance(mod, SparseBatchNorm):
            rows = x.features[x.valid].float()
            mean, var = rows.mean(0), rows.var(0, unbiased=False)
        else:
            mean = x.float().mean((0, 2, 3))
            var = x.float().var((0, 2, 3), unbiased=False)
        mod.running_mean.copy_(mean)
        mod.running_var.copy_(var)
    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, (SparseBatchNorm, BatchNorm))]
    with torch.no_grad():
        model(dict(batch_f32))
    for h in hooks:
        h.remove()

    # ------------------------------------------------------ kernels: conv
    convs = []                       # every sparse conv call, in order

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
    names = {m: n for n, m in model.named_modules()}
    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, (SubMConv3d, SparseConv3d))]
    with torch.no_grad():
        out_ref = model(dict(batch_f32))
    for h in hooks:
        h.remove()
    check(len(convs) == 21, f"expected 21 sparse convs, recorded {len(convs)}")

    scratch = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def quant(x, axis=None):
        """Symmetric int8 with per-tensor (axis None) or per-last-axis scale."""
        amax = x.abs().amax() if axis is None else x.abs().amax(
            dim=tuple(range(x.dim() - 1)))
        s = (amax / 127.0).clamp(min=1e-8)
        return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s

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
            row = {"conv": name, "N": n, "M": m, "K": k, "Cin": cin,
                   "Cout": cout, "present_taps": n_present}
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
            fq, s_f = quant(feats.float())
            wq, s_w = quant(w32.float(), axis=-1)
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
    emit("kernel_conv_by_width", groups=groups,
         times="sums over the convs of each (Cin, Cout, K) group")
    emit("kernel_conv_total", dtype="bf16", convs=len(convs), **totals,
         convs_at_or_under_library=under_library,
         mode=mode(), max_abs_err=worst, tolerance={
             "f32": "max|k-p| <= 1e-4 * max(1, max|p|)",
             "bf16": "|k-p| <= 2^-7 |p| + 1e-5 * max(1, max|p|) per element",
             "s8": "bit-exact (s32 sums and scaled/masked output)"})

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

    def check_boxes_form(boxes, valid, th, what):
        """The boxes form against its plain version (boxes_iou_bev, then the
        plain sweep): keep masks equal; the kernel's IoU bit-equal at every
        pair it evaluated; every needed pair (j < i, both valid) it skipped
        has a plain IoU of exactly 0.  -> (pairs evaluated, pairs needed,
        the most pairs evaluated in one 64 x 64 tile)."""
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
    # boxes form: corners, areas and valid read once, keep written once; the
    # circle test of every needed pair and the IoU of each near pair
    # (csrc/greedy_nms.cu counts the operations); the same chain
    box_terms = {"bytes": 1e3 * s * kc * (32 + 4 + 1 + 1) / HBM_BYTES_PER_S,
                 "operations": 1e3 * (cand_pairs * IOU_CIRCLE_OPS
                                      + near_pairs * IOU_OPS)
                 / PEAK_OPS_PER_S["f32"],
                 "latency": 1e3 * kc * 4 / (clock_mhz * 1e6)}
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

    # ================================= the accuracy gates and fake-quant
    # both in f32 with TF32 off, as the reference's eval_one_epoch runs
    strict_f32(True)
    gates = eval_gates(dev, conv_k, nms_k, mode)
    fakequant_ref(model, batch_f32, conv_k, nms_k, mode, flush)
    strict_f32(False)

    def per_recipe(key):
        return {tag: g["cuda"]["launches"][key] for tag, g in gates.items()}

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
         "checks": "passed", "times_cover": "one bf16 forward (21 convs)"},
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
