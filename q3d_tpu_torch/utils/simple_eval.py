"""Lightweight detection mAP for synthetic evaluation: the port's copy of
``q3d_tpu/utils/simple_eval.py`` (greedy matching, 11-point interpolated AP
at a BEV IoU threshold), with the BEV IoU from the port's
``ops.iou3d_nms.boxes_iou_bev`` on the host.  The reference pads each box
set to a power of two only to bound JAX's recompilations; PyTorch has
none, so the sets go in as they are.
"""

import numpy as np
import torch


def _bev_iou_np(boxes_a, boxes_b):
    from ..ops.iou3d_nms import boxes_iou_bev
    na, nb = len(boxes_a), len(boxes_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), np.float32)
    return boxes_iou_bev(torch.from_numpy(np.asarray(boxes_a, np.float32)),
                         torch.from_numpy(np.asarray(boxes_b, np.float32))
                         ).numpy()


def simple_map(det_annos, gt_annos, class_names, iou_thresh=0.5):
    """det_annos: [{'boxes_lidar','score','name'}]; gt_annos: [{'boxes','names'}]."""
    ap_dict = {}
    for cls in class_names:
        scores, tp_flags, n_gt = [], [], 0
        for det, gt in zip(det_annos, gt_annos):
            det_mask = det["name"] == cls
            gt_mask = gt["names"] == cls
            det_boxes = det["boxes_lidar"][det_mask]
            det_scores = det["score"][det_mask]
            gt_boxes = gt["boxes"][gt_mask]
            n_gt += len(gt_boxes)
            order = np.argsort(-det_scores)
            det_boxes, det_scores = det_boxes[order], det_scores[order]
            iou = _bev_iou_np(det_boxes, gt_boxes)
            taken = np.zeros(len(gt_boxes), bool)
            for i in range(len(det_boxes)):
                scores.append(det_scores[i])
                j = int(np.argmax(iou[i])) if len(gt_boxes) else -1
                if j >= 0 and iou[i, j] >= iou_thresh and not taken[j]:
                    taken[j] = True
                    tp_flags.append(1.0)
                else:
                    tp_flags.append(0.0)
        if n_gt == 0:
            ap_dict[f"AP_{cls}"] = 0.0
            continue
        if not scores:
            ap_dict[f"AP_{cls}"] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(tp_flags)[order]
        cum_tp = np.cumsum(tp)
        recall = cum_tp / n_gt
        precision = cum_tp / (np.arange(len(tp)) + 1)
        ap = 0.0
        for r in np.linspace(0, 1, 11):
            p = precision[recall >= r].max() if (recall >= r).any() else 0.0
            ap += p / 11
        ap_dict[f"AP_{cls}"] = float(ap)
    ap_dict["mAP"] = float(np.mean([v for k, v in ap_dict.items()
                                    if k.startswith("AP_")]))
    return ap_dict
