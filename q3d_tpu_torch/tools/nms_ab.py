"""Kernel 2's boxes form from two sources, timed in turns on one card.

    python -m q3d_tpu_torch.tools.nms_ab --baseline OTHER/greedy_nms.cu

Builds ``csrc/greedy_nms.cu`` and the ``--baseline`` source (another
revision of the same file, with the same C interface) and runs both on the
same candidate sets: centerpoint_ref's decode (6 sets of K = 500, seeded
weights, BN statistics from the first request), random crowded boxes (K =
500, 2048 and 4096) and the KITTI SECOND and PointPillars configs' own
NMS input (2 sets of K = 4096, each under the three validities of
``validities``).  A source runs only up to the K its ``MAX_WORDS`` takes
(the revision before the K = 4096 widening does not check K itself).  Each
set's keep masks must equal the plain version's for both builds; then each
build's median CUDA-event time (L2 flushed before each launch) is taken in
the order baseline, current, current, baseline, and one JSON line per case
gives the four medians (of REPS launches each).  Needs the card.
"""

import argparse
import json
import re
import statistics
from pathlib import Path

import numpy as np
import torch

from ..ops.iou3d_nms import greedy_nms as nms_mod
from ..ops.kernel_build import CudaLibrary, build_all

ROOT = Path(__file__).resolve().parents[2]
REF_CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_ref.yaml"
REPS = 50
# AnchorHeadSingle's conv_cls bias at init, -log((1 - 0.01) / 0.01).  The
# seeded KITTI models set it to 0, so that all 4096 NMS candidates pass
# SCORE_THRESH (kernel 2's worst case); ``validities`` also gives the
# validity this bias would leave the same candidates, and the first
# VALID_FIRST valid (a trained model's share is not known here: no KITTI
# weights are in the repository).
CLS_PRIOR_BIAS = -4.59511985013459
VALID_FIRST = 512


def _max_k(source):
    """The largest K a revision of greedy_nms.cu takes: 64 rows a mask
    word, ``MAX_WORDS`` words a row."""
    words = re.search(r"constexpr int MAX_WORDS = (\d+);",
                      Path(source).read_text())
    return 64 * int(words.group(1))


def _launch(lib, corners, areas, valid, thresh):
    s, k = valid.shape
    words = lib.lib()["q3d_greedy_nms_scratch_words"](s, k, 1)
    scratch = torch.empty(words, dtype=torch.int64, device=corners.device)
    keep = torch.empty((s, k), dtype=torch.bool, device=corners.device)
    lib.call("q3d_greedy_nms_boxes", corners.data_ptr(), areas.data_ptr(),
             valid.data_ptr(), scratch.data_ptr(), keep.data_ptr(), None, s,
             k, float(thresh), torch.cuda.current_stream().cuda_stream)
    return keep


def _median_ms(fn, flush):
    times = []
    for _ in range(REPS):
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


def _ref_decode_sets(dev):
    """centerpoint_ref's first request (batch 2), seeded weights with each
    BN's statistics taken from its input, f32: the head's 6 candidate
    sets, K = NMS_PRE_MAXSIZE, as its NMS gets them."""
    from ..config import EDict, cfg_from_yaml_file
    from ..datasets import build_dataloader
    from ..models import build_network, load_data_to_device
    from ..utils.bn_calibration import calibrate_bns
    cfg = cfg_from_yaml_file(str(REF_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    batch = load_data_to_device(next(iter(loader)), device=dev)
    calibrate_bns(model, batch)
    with torch.no_grad():
        out = model(dict(batch))
        sb, _, _, sv = model.dense_head._decode(out["pred_dicts"])
    nms_cfg = cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG
    k = min(int(nms_cfg.NMS_PRE_MAXSIZE), sb.shape[1])
    return (sb[:, :k, :7].contiguous(), sv[:, :k].contiguous(),
            float(nms_cfg.NMS_THRESH))


def anchor_candidates(out, cfg):
    """An anchor detector's own NMS input from a forward's outputs: per
    frame the best class score of each anchor, stable-sorted descending,
    the first NMS_PRE_MAXSIZE boxes and their validity (score >=
    SCORE_THRESH); and the validity the same candidates would have with
    conv_cls's prior bias added (the order is the same) -> (boxes (B, K,
    7) f32, valid (B, K), prior_valid (B, K))."""
    post = cfg.MODEL.POST_PROCESSING
    logits = out["batch_cls_preds"].float()
    scores = torch.sigmoid(logits).amax(-1)
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    k = min(int(post.NMS_CONFIG.NMS_PRE_MAXSIZE), scores.shape[1])
    order = order[:, :k]
    boxes = out["batch_box_preds"][..., :7].float().gather(
        1, order[..., None].expand(-1, -1, 7)).contiguous()
    thresh = float(post.SCORE_THRESH)
    valid = (scores.gather(1, order) >= thresh).contiguous()
    prior = torch.sigmoid(logits + CLS_PRIOR_BIAS).amax(-1)
    prior_valid = (prior.gather(1, order) >= thresh).contiguous()
    return boxes, valid, prior_valid


def validities(valid, prior_valid):
    """The candidates' validities kernel 2 is timed under: as given (with
    conv_cls's bias 0, all valid), under the prior bias, and the first
    VALID_FIRST -> [(label, (S, K) bool)]."""
    first = torch.zeros_like(valid)
    first[:, :VALID_FIRST] = True
    return [("conv_cls bias 0 (all valid)", valid),
            ("conv_cls prior bias", prior_valid),
            (f"the first {VALID_FIRST} valid", first & valid)]


def _kitti_sets(name, dev):
    """The KITTI config ``name``'s NMS input on its synthetic frames 0-1
    (FOV-cropped), f32 with TF32 off: seeded weights, conv_cls's bias 0,
    BN statistics from the batch -> (boxes, [(label, valid)], thresh)."""
    from ..datasets import build_dataloader
    from ..datasets.kitti_synthetic import kitti_config, kitti_scene
    from ..models import build_network, load_data_to_device
    from ..utils.bn_calibration import calibrate_bns
    cfg = kitti_config(name, num_frames=2, seed=0)
    ds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                batch_size=2, training=False)
    frames = []
    for j in range(2):
        points, boxes, names, _ = kitti_scene(ds, j)
        frames.append(ds.prepare_data({"points": points, "gt_boxes": boxes,
                                       "gt_names": names, "frame_id": j}))
    batch = load_data_to_device(ds.collate_batch(frames), device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    with torch.no_grad():
        model.dense_head.conv_cls.bias.zero_()
    calibrate_bns(model, batch)
    with torch.no_grad():
        out = model(dict(batch))
    boxes, valid, prior_valid = anchor_candidates(out, cfg)
    return (boxes, validities(valid, prior_valid),
            float(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_THRESH))


def _crowded(rng, s, k, dev):
    """S sets of K random boxes crowded into a square of side ~0.8 sqrt(K)
    m (some exact duplicates, some sharing all but the heading), ~90%
    valid: (boxes (S, K, 7), valid (S, K)) on ``dev``."""
    b = np.zeros((s, k, 7), np.float32)
    b[..., 0:2] = rng.uniform(-0.4, 0.4, (s, k, 2)) * np.sqrt(k)
    b[..., 3:6] = rng.uniform(0.5, 4.5, (s, k, 3))
    b[..., 6] = rng.uniform(-np.pi, np.pi, (s, k))
    b[:, 10:20] = b[:, 0:10]
    b[:, 20:30, :6] = b[:, 30:40, :6]
    return (torch.from_numpy(b).to(dev),
            torch.from_numpy(rng.rand(s, k) > 0.1).to(dev))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", required=True,
                        help="another revision of csrc/greedy_nms.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nms_ab times the card's kernels: CUDA is needed")
    dev = torch.device("cuda")
    base = CudaLibrary(nms_mod.KERNEL.source.name, nms_mod.KERNEL.signatures,
                       nms_mod.KERNEL.variants)
    base.source = Path(args.baseline).resolve()
    libs = {"baseline": base, "current": nms_mod.KERNEL}
    max_k = {tag: _max_k(lib.source) for tag, lib in libs.items()}
    build_all(list(libs.values()))
    scratch = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()
    rng = np.random.RandomState(0)
    cases = [("centerpoint_ref decode", *_ref_decode_sets(dev))]
    for s, k in ((6, 500), (6, 2048), (2, 4096)):
        cases.append((f"crowded {s} x {k}", *_crowded(rng, s, k, dev), 0.5))
    for name in ("second", "pointpillar"):
        boxes, sets, thresh = _kitti_sets(name, dev)
        cases += [(f"{name} candidates, {share}", boxes, valid, thresh)
                  for share, valid in sets]
    card = torch.cuda.get_device_name(0)
    for what, boxes, valid, thresh in cases:
        s, k = valid.shape
        corners, areas = nms_mod.bev_corners_areas(boxes)
        want = nms_mod.greedy_suppress_boxes_plain(boxes, valid, thresh)
        row = {"case": what, "sets": s, "K": k, "thresh": thresh,
               "valid": valid.sum(1).tolist(), "card": card}
        runnable = {}
        for tag, lib in libs.items():
            if k > max_k[tag]:
                continue
            keep = _launch(lib, corners, areas, valid, thresh)
            torch.cuda.synchronize()
            if not torch.equal(keep, want):
                raise AssertionError(f"{what}: {tag} keep masks differ from "
                                     f"the plain version")
            runnable[tag] = lib
        if len(runnable) == 2:
            order = ("baseline", "current", "current", "baseline")
        else:
            order = tuple(runnable)
        row["order"] = list(order)
        row["ms"] = [_median_ms(
            lambda lib=runnable[tag]: _launch(lib, corners, areas, valid,
                                              thresh), flush)
            for tag in order]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
