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
                tolerances, s8 with out_scale/out_valid bit-exact), greedy
                NMS exactly equal on that request's 6 IoU matrices and on
                random K = 128 / 1024 ones; median CUDA-event times of the
                kernel, its plain version and the nearest library call;
  4. serving  — CenterPoint at centerpoint_ref (full width, seeded random
                weights, BN statistics calibrated on the first request),
                batch 2, bf16 inputs, 4 requests covering the dataset's 8
                frames; per request the host time (scene + voxelize) and
                the device forward, and the valid detections.  Kernel
                launch counts are zeroed just before and read just after;
  5. stages   — CUDA-event time of each stage of one bf16 forward (VFE,
                sparse backbone, BEV map, 2D backbone, head convs, decode +
                NMS), median of 5;
  6. model    — one request in f32 with TF32 off and cuDNN deterministic
                (as in phase 3 and the BN calibration; the timed bf16
                phases 4-5 run with PyTorch's own settings), through the
                kernels and through the plain versions: BEV maps, every
                head map and the final detections compared; NMS keep masks
                on identical candidates must be equal;
  7. the ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises and exits nonzero without the last line.  Without
CUDA, or outside a checkout of the repo, it exits 1 and prints no result.
``USE_APPROX_TOPK`` in the config is ignored: the port's top-K is exact.
"""

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


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=10, flush=None):
    """Median CUDA-event time of ``fn`` in ms; ``flush`` (run outside the
    timed region before each rep) evicts the 50 MB L2."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    from q3d_tpu_torch.ops.iou3d_nms import candidate_iou
    from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as nms_mod
    from q3d_tpu_torch.ops.spconv import gather_conv
    from q3d_tpu_torch.ops.spconv.modules import (SubMConv3d, SparseConv3d,
                                                  SparseBatchNorm,
                                                  subm_cache_key,
                                                  down_cache_key)
    from q3d_tpu_torch.models.layers import BatchNorm

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
    emit("build", seconds=build_s, libraries=[str(lib.so_path.relative_to(ROOT))
                                              for lib in (conv_k, nms_k)])

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
                check(ok, f"{name} {tag}: kernel vs plain max err "
                          f"{float(err.max())} (scale {float(mag.max())})")
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
    emit("kernel_conv_total", dtype="bf16", convs=len(convs), **totals,
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
    iou, iou_valid = candidate_iou(sb[:, :kc], sv[:, :kc])
    keep_k = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="cuda")
    keep_p = nms_mod.greedy_nms(iou, iou_valid, thresh, impl="plain")
    check(torch.equal(keep_k, keep_p), "greedy_nms: ref-decode keep masks differ")
    g = torch.Generator(device=dev).manual_seed(SEED)
    for s, kk in ((6, 128), (6, 1024)):
        r_iou = torch.rand((s, kk, kk), generator=g, device=dev)
        r_valid = torch.rand((s, kk), generator=g, device=dev) > 0.1
        for th in (0.2, 0.5, 0.9):
            check(torch.equal(nms_mod.greedy_nms(r_iou, r_valid, th, impl="cuda"),
                              nms_mod.greedy_nms(r_iou, r_valid, th, impl="plain")),
                  f"greedy_nms: random K={kk} thresh={th} keep masks differ")
    s, kp, _ = iou.shape
    # the function reads iou[j, i] only for j < i with both valid (the
    # strict upper triangle of each set's valid candidates), reads valid
    # and writes keep once, and does one compare per pair read
    n_cand = iou_valid.sum(1).double()
    pairs = float((n_cand * (n_cand - 1) / 2).sum())
    nms_bytes_ms = 1e3 * (pairs * 4 + 2 * s * kp) / HBM_BYTES_PER_S
    nms_ops_ms = 1e3 * pairs / PEAK_OPS_PER_S["f32"]
    nms_row = {
        "sets": s, "K": kp, "candidate_pairs": pairs, "kept": int(keep_k.sum()),
        "ms": time_ms(lambda: nms_mod.greedy_suppress_cuda(iou, iou_valid, thresh),
                      flush=flush),
        "plain_ms": time_ms(lambda: nms_mod.greedy_suppress_plain(
            iou, iou_valid, thresh), reps=5, flush=flush),
        "bound_ms": max(nms_bytes_ms, nms_ops_ms),
        "bound_by": "bytes" if nms_bytes_ms >= nms_ops_ms else "operations"}
    emit("kernel_nms", **nms_row, max_abs_err=0,
         tolerance="keep masks exactly equal (ref decode + random K=128/1024)")

    # -------------------------------------------------------------- serving
    strict_f32(False)
    conv_k.launches = nms_k.launches = 0
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
    launches = {"sparse_gather_conv": conv_k.launches,
                "greedy_nms": nms_k.launches}
    check(launches["sparse_gather_conv"] == 21 * REQUESTS
          and launches["greedy_nms"] == REQUESTS,
          f"main path launches {launches}")
    emit("serving", config=CFG.name, batch=BATCH, dtype="bf16",
         requests=REQUESTS, launches=launches, mode=mode(),
         steady_forward_ms=statistics.median(
             p["device_forward_ms"] for p in per_request[1:]))

    # ------------------------------------------------------------- stages
    # where one bf16 forward's time goes: CUDA events around each stage of
    # the last request, median of 5 forwards
    stages = {"vfe": model.vfe, "backbone_3d": model.backbone_3d,
              "map_to_bev": model.map_to_bev_module,
              "backbone_2d": model.backbone_2d,
              "head_convs": [head.shared_conv, *head.heads_list],
              "dense_head": head}
    events = {name: [] for name in stages}

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
    stage_ms = {name: [] for name in stages}
    with torch.no_grad():
        for _ in range(5):
            for evs in events.values():
                evs.clear()
            model(dict(batch))
            torch.cuda.synchronize()
            for name, evs in events.items():
                starts = [e for at, e in evs if at == 0]
                ends = [e for at, e in evs if at == 1]
                stage_ms[name].append(sum(a.elapsed_time(b)
                                          for a, b in zip(starts, ends)))
    for h in hooks:
        h.remove()
    stage_ms = {k: statistics.median(v) for k, v in stage_ms.items()}
    stage_ms["decode_nms"] = stage_ms["dense_head"] - stage_ms["head_convs"]
    emit("stages", dtype="bf16", batch=BATCH, mode=mode(), ms=stage_ms,
         sparse_conv_kernels_ms=totals["ms"])

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
              "model f32: NMS keep masks differ on identical candidates")
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
         nms_identical_inputs="keep masks and final detections equal",
         detections_matched=matched, detections=total, matched_fraction=frac)
    strict_f32(False)

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
         "checks": "passed", "times_cover": "one bf16 forward (21 convs)"},
        {"name": "greedy_nms", "route": "cuda",
         "source": "q3d_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "q3d_tpu/ops/iou3d_nms/pallas_nms.py:45",
         "launches": launches["greedy_nms"], "max_abs_err": 0.0,
         "ms": nms_row["ms"], "plain_ms": nms_row["plain_ms"],
         "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
         "library_ms": None, "checks": "passed",
         "times_cover": f"one forward's batched sweep ({s} sets, K={kp})"}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
