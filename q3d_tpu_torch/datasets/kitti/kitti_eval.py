"""KITTI official-protocol AP evaluation (numpy, the rotated overlaps in
torch).

Port of ``q3d_tpu/datasets/kitti/kitti_eval.py``: 40-recall-point
interpolated AP for the bbox / BEV / 3D metrics (and AOS), per class and
difficulty, with the official ignore / DontCare rules (``_clean_data``),
the TP-score threshold sampling and the greedy per-frame matching.  The
rotated BEV and 3D overlaps are the port's ``boxes_iou_bev`` /
``boxes_iou3d`` on the device the evaluation is given (the card by
default; the CPU where the caller asks), where the reference calls its XLA
IoU; each frame's overlaps are computed once per metric and shared by the
classes and difficulties.

anno format (as the reference's): a dict with 'name', 'truncated',
'occluded', 'alpha', 'bbox' (N, 4), 'dimensions' (N, 3: l, h, w),
'location' (N, 3, camera), 'rotation_y', and 'score' (detections only).
"""

import numpy as np
import torch

from ...ops.iou3d_nms import boxes_iou3d, boxes_iou_bev
from ...utils.common_utils import resolve_device

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting",
               "Truck"]
MIN_HEIGHTS = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


def _clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Official per-frame GT/DT filtering. Returns (num_valid_gt,
    ignored_gt (M,), ignored_dt (N,), dontcare boxes (K,4))."""
    cls_name = CLASS_NAMES[current_class].lower()
    ignored_gt, dontcare = [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = gt_anno["name"][i].lower()
        if name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and name == "van":
            valid_class = 0
        else:
            valid_class = -1
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHTS[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if name == "dontcare":
            dontcare.append(gt_anno["bbox"][i])

    ignored_dt = []
    for i in range(len(dt_anno["name"])):
        if dt_anno["name"][i].lower() == cls_name:
            valid_class = 1
        else:
            valid_class = -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHTS[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = np.asarray(dontcare).reshape(-1, 4)
    return num_valid_gt, np.asarray(ignored_gt, np.int64), \
        np.asarray(ignored_dt, np.int64), dc


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """(N,4) x (K,4) image IoU (criterion -1=union, 0=a, 1=b)."""
    N, K = len(boxes), len(query_boxes)
    overlaps = np.zeros((N, K), np.float64)
    if N == 0 or K == 0:
        return overlaps
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_b = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        union = area_a + area_b - inter
    elif criterion == 0:
        union = area_a
    else:
        union = area_b
    return inter / np.clip(union, 1e-9, None)


def _camera_to_lidar_like(anno):
    """(N, 7) boxes in a z-up frame from camera-frame annos, for the
    rotated IoU: x = cam x, y = cam z, heading = -ry."""
    loc = anno["location"]
    dims = anno["dimensions"]              # l, h, w
    ry = anno["rotation_y"]
    n = len(loc)
    if n == 0:
        return np.zeros((0, 7), np.float32)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = loc[:, 0]
    boxes[:, 1] = loc[:, 2]
    boxes[:, 2] = -loc[:, 1] + dims[:, 1] / 2   # bottom -> center, z-up
    boxes[:, 3] = dims[:, 0]                    # l along heading
    boxes[:, 4] = dims[:, 2]                    # w
    boxes[:, 5] = dims[:, 1]                    # h
    boxes[:, 6] = -ry
    return boxes


def _rotated_overlap(fn, gt_boxes7, dt_boxes7, device):
    if len(gt_boxes7) == 0 or len(dt_boxes7) == 0:
        return np.zeros((len(gt_boxes7), len(dt_boxes7)), np.float64)
    dev = resolve_device(device)
    iou = fn(torch.from_numpy(np.ascontiguousarray(gt_boxes7)).to(dev),
             torch.from_numpy(np.ascontiguousarray(dt_boxes7)).to(dev))
    return iou.cpu().numpy().astype(np.float64)


def bev_box_overlap(gt_boxes7, dt_boxes7, device=None):
    """Rotated BEV IoU (N, 7) x (K, 7) -> (N, K) float64, on ``device``."""
    return _rotated_overlap(boxes_iou_bev, gt_boxes7, dt_boxes7, device)


def d3_box_overlap(gt_boxes7, dt_boxes7, device=None):
    """3D IoU (N, 7) x (K, 7) -> (N, K) float64, on ``device``."""
    return _rotated_overlap(boxes_iou3d, gt_boxes7, dt_boxes7, device)


def frame_overlaps(gt_annos, dt_annos, metric, device=None):
    """Each frame's gt x detection overlaps under ``metric`` (0 image box,
    1 BEV, 2 3D) -> [(N, K) float64]."""
    out = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            out.append(image_box_overlap(gt["bbox"], dt["bbox"]))
            continue
        g7, d7 = _camera_to_lidar_like(gt), _camera_to_lidar_like(dt)
        out.append(bev_box_overlap(g7, d7, device) if metric == 1
                   else d3_box_overlap(g7, d7, device))
    return out


def _compute_statistics(overlaps, gt_anno, dt_anno, ignored_gt, ignored_dt,
                        dc_bboxes, metric, min_overlap, thresh=0.0,
                        compute_fp=False, compute_aos=False):
    """Official compute_statistics_jit logic for one frame.

    overlaps: (num_gt, num_dt). Returns (tp, fp, fn, similarity,
    thresholds-of-TPs); ``similarity`` is the AOS numerator
    sum((1+cos(gt_alpha - dt_alpha))/2) over TP pairs (reference
    eval.py:168-304 thread alpha through the same matching loop), or -1
    when compute_aos is off."""
    dt_scores = dt_anno["score"]
    num_gt, num_dt = overlaps.shape
    assigned = np.zeros(num_dt, bool)
    ignored_threshold = np.zeros(num_dt, bool)
    if compute_fp:
        ignored_threshold = dt_scores < thresh
    tp = fp = fn = 0
    thresholds = []
    deltas = []
    for i in range(num_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = -np.inf
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(num_dt):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[i, j]
            score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and score > valid_detection:
                det_idx = j
                valid_detection = score
            elif compute_fp and overlap > min_overlap \
                    and (overlap > max_overlap or assigned_ignored_det) \
                    and ignored_dt[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap \
                    and valid_detection == -np.inf and ignored_dt[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == -np.inf and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != -np.inf \
                and (ignored_gt[i] == 1 or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != -np.inf:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt_anno["alpha"][i] - dt_anno["alpha"][det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(num_dt):
            if not (assigned[j] or ignored_dt[j] == -1
                    or ignored_dt[j] == 1 or ignored_threshold[j]):
                fp += 1
        # dontcare absorption (bbox metric only): unassigned positive-class
        # detections overlapping a DontCare region are not false positives
        # (official eval.py:248-262 — each det absorbed at most once)
        if metric == 0 and len(dc_bboxes):
            dt_bboxes = dt_anno["bbox"]
            ov = image_box_overlap(dt_bboxes, dc_bboxes, criterion=0)
            nstuff = 0
            for i in range(len(dc_bboxes)):
                for j in range(num_dt):
                    if assigned[j] or ignored_dt[j] in (-1, 1) \
                            or ignored_threshold[j]:
                        continue
                    if ov[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
            fp -= nstuff
    similarity = -1.0
    if compute_aos:
        similarity = float(np.sum((1.0 + np.cos(np.asarray(deltas))) / 2.0)) \
            if deltas else 0.0
    return tp, fp, fn, similarity, thresholds


def _get_thresholds(scores, num_gt):
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.asarray(thresholds)


def eval_class(gt_annos, dt_annos, current_class, difficulty, metric,
               min_overlap, compute_aos=False, overlaps=None, device=None):
    """AP_R40 (and optionally AOS_R40, bbox metric only) for one
    (class, difficulty, metric, min_overlap); ``overlaps``: the frames'
    ``frame_overlaps`` under ``metric``, computed here when not given."""
    if overlaps is None:
        overlaps = frame_overlaps(gt_annos, dt_annos, metric, device)
    frames = []
    total_valid_gt = 0
    for gt, dt, ov in zip(gt_annos, dt_annos, overlaps):
        num_valid_gt, ig_gt, ig_dt, dc = _clean_data(
            gt, dt, current_class, difficulty)
        total_valid_gt += num_valid_gt
        frames.append((ov, gt, dt, ig_gt, ig_dt, dc, num_valid_gt))
    if total_valid_gt == 0:
        return (0.0, np.zeros(N_SAMPLE_PTS), 0.0) if compute_aos \
            else (0.0, np.zeros(N_SAMPLE_PTS))

    all_thresholds = []
    for ov, gt, dt, ig_gt, ig_dt, dc, nv in frames:
        *_, th = _compute_statistics(ov, gt, dt, ig_gt, ig_dt, dc,
                                     metric, min_overlap)
        all_thresholds += th
    thresholds = _get_thresholds(np.asarray(all_thresholds), total_valid_gt)
    if len(thresholds) == 0:
        return (0.0, np.zeros(N_SAMPLE_PTS), 0.0) if compute_aos \
            else (0.0, np.zeros(N_SAMPLE_PTS))

    pr = np.zeros((len(thresholds), 4))     # tp, fp, fn, similarity
    for ti, t in enumerate(thresholds):
        for ov, gt, dt, ig_gt, ig_dt, dc, nv in frames:
            tp, fp, fn, sim, _ = _compute_statistics(
                ov, gt, dt, ig_gt, ig_dt, dc, metric, min_overlap,
                thresh=t, compute_fp=True, compute_aos=compute_aos)
            pr[ti] += (tp, fp, fn, max(sim, 0.0))
    precision = np.zeros(N_SAMPLE_PTS)
    aos_curve = np.zeros(N_SAMPLE_PTS)
    for ti in range(len(thresholds)):
        denom = max(pr[ti, 0] + pr[ti, 1], 1e-9)
        precision[ti] = pr[ti, 0] / denom
        if compute_aos:
            aos_curve[ti] = pr[ti, 3] / denom
    # right-max interpolation
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
        aos_curve[i - 1] = max(aos_curve[i - 1], aos_curve[i])
    ap = precision[1:].sum() / (N_SAMPLE_PTS - 1) * 100.0
    if compute_aos:
        aos = aos_curve[1:].sum() / (N_SAMPLE_PTS - 1) * 100.0
        return ap, precision, aos
    return ap, precision


# class -> [bbox, bev, 3d] min overlaps (official "moderate" table)
MIN_OVERLAPS = {
    "Car": (0.7, 0.7, 0.7),
    "Pedestrian": (0.5, 0.5, 0.5),
    "Cyclist": (0.5, 0.5, 0.5),
    "Van": (0.7, 0.7, 0.7),
    "Truck": (0.7, 0.7, 0.7),
    "Person_sitting": (0.5, 0.5, 0.5),
}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             device=None):
    """The official AP_R40 table of ``current_classes`` -> (result string,
    {"<class>_<metric>/<difficulty>_R40": AP}); rotated overlaps on
    ``device`` (None: the card)."""
    if isinstance(current_classes, str):
        current_classes = [current_classes]
    # AOS requires predicted observation angles (reference gates on a dt
    # anno having alpha[0] != -10 — eval.py get_official_eval_result)
    def _has_alpha(dt):
        a = np.asarray(dt.get("alpha", np.zeros(0)))
        return a.size > 0 and float(a.flat[0]) != -10
    compute_aos = any(_has_alpha(dt) for dt in dt_annos)
    result_str = ""
    result_dict = {}
    diff_names = ["easy", "moderate", "hard"]
    overlaps = {metric: frame_overlaps(gt_annos, dt_annos, metric, device)
                for metric in range(3)}
    for cls_name in current_classes:
        cls_idx = CLASS_NAMES.index(cls_name)
        mo = MIN_OVERLAPS[cls_name]
        for metric, mname in [(0, "bbox"), (1, "bev"), (2, "3d")]:
            aps, aoss = [], []
            for d in range(3):
                if metric == 0 and compute_aos:
                    ap, _, aos = eval_class(gt_annos, dt_annos, cls_idx, d,
                                            metric, mo[metric],
                                            compute_aos=True,
                                            overlaps=overlaps[metric])
                    aoss.append(aos)
                    result_dict[f"{cls_name}_aos/{diff_names[d]}_R40"] = aos
                else:
                    ap, _ = eval_class(gt_annos, dt_annos, cls_idx, d,
                                       metric, mo[metric],
                                       overlaps=overlaps[metric])
                aps.append(ap)
                result_dict[f"{cls_name}_{mname}/{diff_names[d]}_R40"] = ap
            result_str += (f"{cls_name} AP_R40@{mo[metric]:.2f} ({mname}): "
                           f"{aps[0]:.4f}, {aps[1]:.4f}, {aps[2]:.4f}\n")
            if aoss:
                result_str += (f"{cls_name} AOS_R40: "
                               f"{aoss[0]:.4f}, {aoss[1]:.4f}, {aoss[2]:.4f}\n")
    return result_str, result_dict
