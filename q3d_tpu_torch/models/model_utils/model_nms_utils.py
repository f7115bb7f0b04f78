"""NMS dispatch (port of ``q3d_tpu/models/model_utils/model_nms_utils.py``:
``class_agnostic_nms``, ``multi_classes_nms`` :39, ``class_specific_nms``
:64), batched over candidate sets, fixed-size outputs.  The first two run
every set of a batch in one NMS call (one launch of kernel 2),
``class_specific_nms`` one per NMS threshold."""

import torch

from ...ops.iou3d_nms import nms_bev, nms_normal_bev

_NMS_FNS = {"nms_gpu": nms_bev, "nms_bev": nms_bev,
            "nms_normal_gpu": nms_normal_bev, "nms_normal_bev": nms_normal_bev}


def _nms_args(nms_config, thresh=None):
    return {"thresh": float(nms_config.NMS_THRESH if thresh is None
                            else thresh),
            "pre_maxsize": int(nms_config.NMS_PRE_MAXSIZE),
            "post_maxsize": int(nms_config.NMS_POST_MAXSIZE)}


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None,
                       box_valid=None, presorted=False, impl=None):
    """box_scores (S, N); box_preds (S, N, 7+) -> (idx, valid) (S, P).

    presorted=True: rows are already in descending score order (they come
    straight out of the top-K decode)."""
    valid = torch.ones_like(box_scores, dtype=torch.bool) if box_valid is None \
        else box_valid
    if score_thresh is not None:
        valid = valid & (box_scores >= score_thresh)
    nms_fn = _NMS_FNS[nms_config.NMS_TYPE]
    kw = {"presorted": True} if presorted and nms_fn is nms_bev else {}
    return nms_fn(box_preds, box_scores, score_valid=valid, impl=impl,
                  **_nms_args(nms_config), **kw)


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None,
                      box_valid=None, impl=None):
    """Per-class NMS (reference :39): cls_scores (B, N, C), box_preds (B, N,
    7+) -> (idx, valid, scores), each (B, C, P): class k's NMS over every
    row of its frame, scored by column k.  The B x C sets run in one NMS
    call; each reads its top ``NMS_PRE_MAXSIZE`` rows of the frame's boxes
    by index."""
    b, n, c = cls_scores.shape
    scores = cls_scores.permute(0, 2, 1).reshape(b * c, n)
    valid = torch.ones_like(scores, dtype=torch.bool) if box_valid is None \
        else box_valid[:, None].expand(b, c, n).reshape(b * c, n)
    if score_thresh is not None:
        valid = valid & (scores >= score_thresh)
    idx, val = _NMS_FNS[nms_config.NMS_TYPE](
        box_preds, scores, score_valid=valid, impl=impl,
        **_nms_args(nms_config))
    return (idx.reshape(b, c, -1), val.reshape(b, c, -1),
            scores.gather(1, idx).reshape(b, c, -1))


def stable_top(scores, k):
    """The ``k`` largest of each row, ties in index order, as ``lax.top_k``
    gives them -> (values, indices)."""
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def class_specific_nms(box_scores, box_preds, box_labels, nms_config,
                       score_thresh=None, box_valid=None, impl=None):
    """Per-class NMS with per-class thresholds (reference :64): box_scores,
    box_labels (1-based) (B, N), box_preds (B, N, 7+) -> (idx, valid)
    (B, P): the union of the classes' survivors, score-ordered.  The
    classes are NMS_THRESH's entries when it is a list, else
    ``NUM_CLASSES`` (3) sharing it; a list SCORE_THRESH is read per label.
    Rotated NMS, as the reference's; the classes that share a threshold
    run as B x classes candidate sets of one NMS call."""
    thresholds = nms_config.NMS_THRESH
    per_class = isinstance(thresholds, (list, tuple))
    num_class = len(thresholds) if per_class \
        else int(nms_config.get("NUM_CLASSES", 3))
    base_valid = torch.ones_like(box_scores, dtype=torch.bool) \
        if box_valid is None else box_valid
    if score_thresh is not None:
        thr = score_thresh
        if isinstance(thr, (list, tuple)):
            thr = torch.tensor(list(thr), dtype=box_scores.dtype,
                               device=box_scores.device)[box_labels - 1]
        base_valid = base_valid & (box_scores >= thr)
    groups = {}
    for k in range(1, num_class + 1):
        groups.setdefault(float(thresholds[k - 1] if per_class
                                else thresholds), []).append(k)
    b, n = box_scores.shape
    per_k = {}
    for thresh, ks in groups.items():
        g = len(ks)
        valid = torch.stack([base_valid & (box_labels == k) for k in ks],
                            dim=1).reshape(b * g, n)
        scores = box_scores[:, None].expand(b, g, n).reshape(b * g, n)
        idx, val = nms_bev(box_preds, scores, score_valid=valid, impl=impl,
                           **_nms_args(nms_config, thresh))
        idx, val = idx.reshape(b, g, -1), val.reshape(b, g, -1)
        for j, k in enumerate(ks):
            per_k[k] = (idx[:, j], val[:, j])
    all_idx = [per_k[k][0] for k in range(1, num_class + 1)]
    all_scores = [torch.where(per_k[k][1], box_scores.gather(1, per_k[k][0]),
                              box_scores.new_tensor(-1.0))
                  for k in range(1, num_class + 1)]
    top_s, pos = stable_top(torch.cat(all_scores, dim=1),
                            int(nms_config.NMS_POST_MAXSIZE))
    return torch.cat(all_idx, dim=1).gather(1, pos), top_s > 0
