"""Self-contained nuScenes detection metrics (numpy): the port's copy of
``q3d_tpu/datasets/nuscenes/nuscenes_eval.py``, unchanged.

The reference delegates to the external ``nuscenes-devkit``
(``pcdet/datasets/nuscenes/nuscenes_dataset.py:257-311``); that package is
not available here, so this module re-implements the official protocol:

  * per-class evaluation range filtering (devkit class_range config);
  * center-distance matching at D = {0.5, 1, 2, 4} m per class;
  * AP = normalized area of the (recall, precision) curve above
    (0.1, 0.1) — the devkit's clipped-and-rescaled integral;
  * TP metrics at D=2 m matches: ATE (m), ASE (1-IoU of aligned boxes),
    AOE (rad; traffic_cone excluded), AVE (m/s; barrier/traffic_cone
    excluded), AAE (1 - attribute accuracy; barrier/traffic_cone excluded,
    only when annos carry 'attributes');
  * NDS = (5 * mAP + sum_tp max(0, 1 - err)) / (5 + n_tp) — the devkit
    composition with raw TP errors.

Inputs: det/gt annos as dicts with 'boxes' (N, 9: x y z dx dy dz yaw vx vy),
'names' (N,), det also 'scores' (N,), optionally 'attributes' (N,) strings
on both sides (the dataset's prediction formatter defaults them from the
velocity heuristic, mirroring reference nuscenes_utils.py:525-541).
"""

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# devkit detection_cvpr_2019 class_range (meters from ego)
CLS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
NO_ORIENT = ("traffic_cone",)
NO_VEL = ("barrier", "traffic_cone")
NO_ATTR = ("barrier", "traffic_cone")


def _angle_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return np.minimum(d, period - d)


def _scale_iou(det_box, gt_box):
    """IoU of aligned, centered boxes (size-only) — devkit scale_iou."""
    mins = np.minimum(det_box[3:6], gt_box[3:6])
    inter = np.prod(mins)
    union = np.prod(det_box[3:6]) + np.prod(gt_box[3:6]) - inter
    return inter / max(union, 1e-9)


def _in_range(boxes, class_name):
    """devkit filter_eval_boxes: keep boxes within the class's eval range
    (ego at the origin of the box frame)."""
    r = CLS_RANGE.get(class_name)
    if r is None or not len(boxes):
        return np.ones(len(boxes), bool)
    return np.linalg.norm(boxes[:, :2], axis=1) < r


def accumulate_class(dets, gts, class_name, dist_th):
    """All-frame accumulation for one (class, distance threshold).

    Returns dict with precision/recall arrays and tp-metric lists."""
    npos = 0
    gt_keep = []
    for g in gts:
        keep = (g["names"] == class_name) & _in_range(g["boxes"], class_name)
        gt_keep.append(keep)
        npos += int(keep.sum())
    rows = []   # (score, frame, det_idx)
    for fi, det in enumerate(dets):
        mask = (det["names"] == class_name) \
            & _in_range(det["boxes"], class_name)
        for di in np.where(mask)[0]:
            rows.append((det["scores"][di], fi, di))
    rows.sort(key=lambda r: -r[0])

    taken = [set() for _ in gts]
    tp, fp = [], []
    errs = {"trans": [], "scale": [], "orient": [], "vel": [], "attr": []}
    for score, fi, di in rows:
        det_box = dets[fi]["boxes"][di]
        gt = gts[fi]
        gidx = np.where(gt_keep[fi])[0]
        best_j, best_d = -1, np.inf
        for j in gidx:
            if j in taken[fi]:
                continue
            d = np.linalg.norm(det_box[:2] - gt["boxes"][j][:2])
            if d < best_d:
                best_d, best_j = d, j
        if best_j >= 0 and best_d < dist_th:
            taken[fi].add(best_j)
            tp.append(1)
            fp.append(0)
            gt_box = gt["boxes"][best_j]
            errs["trans"].append(best_d)
            errs["scale"].append(1 - _scale_iou(det_box, gt_box))
            if class_name not in NO_ORIENT:
                period = np.pi if class_name == "barrier" else 2 * np.pi
                errs["orient"].append(
                    _angle_diff(det_box[6], gt_box[6], period))
            if class_name not in NO_VEL and len(det_box) >= 9 \
                    and len(gt_box) >= 9:
                errs["vel"].append(
                    float(np.linalg.norm(det_box[7:9] - gt_box[7:9])))
            if class_name not in NO_ATTR and "attributes" in dets[fi] \
                    and "attributes" in gt:
                errs["attr"].append(
                    0.0 if dets[fi]["attributes"][di]
                    == gt["attributes"][best_j] else 1.0)
        else:
            tp.append(0)
            fp.append(1)

    if npos == 0 or not rows:
        return {"ap": 0.0, "errs": errs, "npos": npos}
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / npos
    precision = tp / np.maximum(tp + fp, 1e-9)
    # devkit: interpolate precision onto 101 recall points, clip, rescale
    rec_interp = np.linspace(0, 1, 101)
    prec_interp = np.interp(rec_interp, recall, precision, right=0)
    prec_interp = prec_interp[rec_interp >= MIN_RECALL]
    prec_interp = np.clip(prec_interp - MIN_PRECISION, 0, None) \
        / (1 - MIN_PRECISION)
    ap = float(prec_interp.mean())
    return {"ap": ap, "errs": errs, "npos": npos}


def nuscenes_eval(det_annos, gt_annos, class_names, verbose=False):
    """-> (result_str, dict with per-class APs, TP errors, mAP, NDS)."""
    metrics = {}
    ap_all = []
    has_attrs = any("attributes" in g for g in gt_annos) \
        and any("attributes" in d for d in det_annos)
    tp_metrics = {"trans": [], "scale": [], "orient": [], "vel": []}
    if has_attrs:
        tp_metrics["attr"] = []
    for cls in class_names:
        aps = []
        for dist_th in DIST_THRESHOLDS:
            acc = accumulate_class(det_annos, gt_annos, cls, dist_th)
            aps.append(acc["ap"])
            if dist_th == TP_DIST:
                for k in tp_metrics:
                    # devkit: classes excluded from a TP metric contribute
                    # nothing to its mean (not a 1.0 penalty)
                    excluded = (
                        (k == "orient" and cls in NO_ORIENT)
                        or (k == "vel" and cls in NO_VEL)
                        or (k == "attr" and cls in NO_ATTR))
                    if excluded:
                        continue
                    vals = acc["errs"][k]
                    tp_metrics[k].append(np.mean(vals) if vals else 1.0)
        cls_ap = float(np.mean(aps))
        metrics[f"AP_{cls}"] = cls_ap
        ap_all.append(cls_ap)
    mAP = float(np.mean(ap_all)) if ap_all else 0.0

    # devkit NDS composition: raw TP errors, score = max(0, 1 - err)
    name_map = {"trans": "mATE", "scale": "mASE", "orient": "mAOE",
                "vel": "mAVE", "attr": "mAAE"}
    tp_errors = {}
    for k, vals in tp_metrics.items():
        tp_errors[name_map[k]] = float(np.mean(vals)) if vals else 1.0
    tp_scores = [max(0.0, 1.0 - e) for e in tp_errors.values()]
    nds = float((5 * mAP + sum(tp_scores)) / (5 + len(tp_scores)))
    metrics.update(tp_errors)
    metrics["mAP"] = mAP
    metrics["NDS"] = nds
    lines = [f"{k}: {v:.4f}" for k, v in metrics.items()]
    return "\n".join(lines), metrics
