"""Rotated BEV IoU and rotated greedy NMS, batched over candidate sets.

Port of ``q3d_tpu/ops/iou3d_nms/iou3d_nms_utils.py`` (``boxes_iou_bev``,
``boxes_iou3d`` and ``_nms_impl`` with its presorted path and cumsum compaction,
for ``nms_bev`` and the axis-aligned ``nms_normal_bev``).  The
intersection area is computed data-parallel over all pairs: each quad edge
is interval-clipped to the other quad's half-planes (Liang-Barsky) and
contributes its shoelace term.  Every 4-term sum and the mean are written
out left to right, so that the CUDA kernel, which evaluates the same
formula pair by pair, rounds exactly as this version does on the card.
``nms_bev`` runs on ``greedy_nms.greedy_nms_boxes`` (on the card, the
kernel computes the IoU itself and no (K, K) matrix is built).
"""

import torch

from ...utils import box_utils
from .greedy_nms import greedy_nms, greedy_nms_boxes

_EPS = 1e-8
_BIAS = 1e-3   # collinear-boundary exclusion margin (scaled distance units)


def _cross2(o, a, b):
    """2D cross product (a-o) x (b-o); broadcasting over leading dims."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _clipped_edges_contrib(poly, clip, origin, bias):
    """Shoelace contributions of ``poly``'s edges clipped to the inside of
    convex ``clip``; -> (contrib (...,), net traversal vector (..., 2))."""
    p1 = poly                                          # (...,4,2)
    p2 = torch.roll(poly, -1, dims=-2)
    c1 = clip[..., None, :, :]                         # (...,1,4,2)
    c2 = torch.roll(clip, -1, dims=-2)[..., None, :, :]
    d1 = _cross2(c1, c2, p1[..., :, None, :]) - bias   # (...,4poly,4clip)
    d2 = _cross2(c1, c2, p2[..., :, None, :]) - bias
    denom = d1 - d2
    safe = torch.where(denom.abs() < _EPS, torch.ones_like(denom), denom)
    tc = d1 / safe                                     # crossing parameter
    t0 = torch.where((d1 < 0) & (d2 >= 0), tc, 0.0).amax(dim=-1)
    t1 = torch.where((d1 >= 0) & (d2 < 0), tc, 1.0).amin(dim=-1)
    keep = ~(((d1 < 0) & (d2 < 0)).any(dim=-1) | (t0 >= t1))
    keepf = keep.to(poly.dtype)[..., None]
    e = p2 - p1
    o = origin[..., None, :]
    q1 = (p1 - o + t0[..., None] * e) * keepf
    q2 = (p1 - o + t1[..., None] * e) * keepf
    contrib = 0.5 * (q1[..., 0] * q2[..., 1] - q1[..., 1] * q2[..., 0])
    net = q2 - q1
    return (_sum4(contrib[..., 0], contrib[..., 1], contrib[..., 2],
                  contrib[..., 3]),
            _sum4(net[..., 0, :], net[..., 1, :], net[..., 2, :],
                  net[..., 3, :]))


def _sum4(a, b, c, d):
    """a + b + c + d, left to right (a reduction's order is the library's)."""
    return a + b + c + d


def _rotated_overlap_quads(qa, qb):
    """Intersection area of two convex quads; qa, qb: (..., 4, 2)."""
    shape = torch.broadcast_shapes(qa.shape, qb.shape)
    qa = qa.expand(shape)
    qb = qb.expand(shape)
    origin = _sum4(qa[..., 0, :], qa[..., 1, :], qa[..., 2, :],
                   qa[..., 3, :]) * 0.25
    a1, v1 = _clipped_edges_contrib(qa, qb, origin, 0.0)
    a2, v2 = _clipped_edges_contrib(qb, qa, origin, _BIAS)
    v = v1 + v2
    closed = (v[..., 0].abs() + v[..., 1].abs()) < 1e-2
    area = a1 + a2
    # max(area, 0) on a closed boundary; +0.0 where it is not (a clamp
    # would leave the sign of a -0.0 to the library)
    return torch.where(closed & (area > 0), area, 0.0)


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU. (..., N, 7), (..., M, 7) -> (..., N, M)."""
    overlap = boxes_bev_overlap(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / (area_a + area_b - overlap).clamp(min=1e-6)


def boxes_bev_overlap(boxes_a, boxes_b):
    """Rotated BEV intersection area. (..., N, 7), (..., M, 7) -> (..., N, M)."""
    qa = box_utils.boxes_to_corners_bev(boxes_a)[..., :, None, :, :]
    qb = box_utils.boxes_to_corners_bev(boxes_b)[..., None, :, :, :]
    return _rotated_overlap_quads(qa, qb)


def _height_overlap(boxes_a, boxes_b):
    za1 = boxes_a[..., 2] - boxes_a[..., 5] / 2
    za2 = boxes_a[..., 2] + boxes_a[..., 5] / 2
    zb1 = boxes_b[..., 2] - boxes_b[..., 5] / 2
    zb2 = boxes_b[..., 2] + boxes_b[..., 5] / 2
    return (torch.minimum(za2[..., :, None], zb2[..., None, :])
            - torch.maximum(za1[..., :, None], zb1[..., None, :])).clamp(min=0)


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU (reference ``boxes_iou3d``, :117-126): the BEV overlap times
    the height overlap over the union of the volumes.
    (..., N, 7), (..., M, 7) -> (..., N, M)."""
    overlap_3d = boxes_bev_overlap(boxes_a, boxes_b) \
        * _height_overlap(boxes_a, boxes_b)
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / (vol_a + vol_b - overlap_3d).clamp(min=1e-6)


def candidate_iou(boxes, valid):
    """(S, K, 7+) score-ordered candidates -> (iou (S, Kp, Kp), valid (S, Kp))
    with K zero-padded to a multiple of 128, as the reference pads: the
    input of kernel 2's IoU form (``greedy_nms.greedy_nms``)."""
    k = boxes.shape[1]
    kp = -(-k // 128) * 128
    if kp != k:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, kp - k))
        valid = torch.nn.functional.pad(valid, (0, kp - k))
    box7 = boxes[..., :7]
    return boxes_iou_bev(box7, box7).contiguous(), valid.contiguous()


def top_candidates(boxes, scores, score_valid, k, presorted=False):
    """Each set's top-``k`` rows in descending score order -> (order (S, k)
    row indices, boxes (S, k, 7+), valid (S, k)).  boxes (S, N, 7+), or
    (F, N, 7+) shared by the S = F x G sets, set s reading frame s // G:
    each set's rows are then selected by index, without a copy of the
    frame's boxes per set."""
    s = scores.shape[0]
    if score_valid is None:
        score_valid = torch.ones_like(scores, dtype=torch.bool)
    if presorted:
        order = torch.arange(k, device=scores.device).expand(s, k)
        return order, boxes[:, :k], score_valid[:, :k]
    masked = torch.where(score_valid, scores, torch.full_like(scores, -1e9))
    # stable descending sort: ties keep the lower index first, as lax.top_k
    # does (torch.topk promises no order among ties)
    top_scores, order = torch.sort(masked, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    if boxes.shape[0] == s:
        top_boxes = boxes.gather(
            1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    else:
        frame = torch.arange(s, device=scores.device) \
            // (s // boxes.shape[0])
        top_boxes = boxes[frame[:, None], order]
    return order, top_boxes, top_scores > -1e9 / 2


def _first_kept(keep, order, post_maxsize):
    """keep (S, K) over score-ordered rows -> (idx, valid) (S, P): the
    first P kept rows' indices (``order``) and a mask of the filled slots.
    The rows are score-ordered, so a stable cumsum compaction selects
    them in order."""
    s, k = keep.shape
    p = min(int(post_maxsize), k)
    kpos = torch.cumsum(keep.long(), dim=1) - 1
    slot = torch.where(keep & (kpos < p), kpos, torch.full_like(kpos, p))
    sel_pos = torch.full((s, p + 1), k, dtype=torch.long, device=keep.device)
    sel_pos.scatter_(1, slot, torch.arange(k, device=keep.device).expand(s, k))
    sel_pos = sel_pos[:, :p]
    sel_valid = sel_pos < k
    sel_idx = torch.where(sel_valid, order.gather(1, sel_pos.clamp(max=k - 1)),
                          torch.zeros_like(sel_pos))
    return sel_idx, sel_valid


def nms_bev(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=500,
            score_valid=None, presorted=False, impl=None):
    """Rotated greedy NMS (reference ``nms_gpu``) over S candidate sets, in
    one launch of kernel 2's boxes form.

    boxes (S, N, 7+), or (F, N, 7+) shared by the S = F x G sets (set s
    reads frame s // G; not with presorted); scores, score_valid (S, N).
    presorted=True: rows are already in descending score order.  Returns
    (idx, valid): (S, P) int64 indices into each set's rows in descending
    score order and a mask of the surviving entries, P = min(post_maxsize,
    pre_maxsize, N)."""
    k = min(int(pre_maxsize), scores.shape[1])
    order, top_boxes, top_valid = top_candidates(boxes, scores, score_valid,
                                                 k, presorted)
    keep = greedy_nms_boxes(top_boxes, top_valid.contiguous(), float(thresh),
                            impl=impl)
    return _first_kept(keep, order, post_maxsize)


def nms_normal_bev(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=500,
                   score_valid=None, impl=None):
    """Axis-aligned greedy NMS (reference ``nms_normal_gpu``,
    ``iou3d_nms_utils.py:272``): the BEV IoU of the boxes' axis-aligned
    extents, rotation ignored, then kernel 2's IoU form (``greedy_nms``).
    K is padded to a multiple of 128 with invalid rows, as the reference
    pads.  Arguments and result as ``nms_bev``'s (no presorted form)."""
    k = min(int(pre_maxsize), scores.shape[1])
    order, top_boxes, top_valid = top_candidates(boxes, scores, score_valid,
                                                 k)
    kp = -(-k // 128) * 128
    if kp != k:
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, kp - k))
        top_valid = torch.nn.functional.pad(top_valid, (0, kp - k))
    keep = greedy_nms(aligned_iou_bev(top_boxes), top_valid.contiguous(),
                      float(thresh), impl=impl)
    return _first_kept(keep[:, :k], order, post_maxsize)


def aligned_iou_bev(boxes):
    """The BEV IoU of each set's boxes' axis-aligned extents, rotation
    ignored: (S, K, 7+) -> (S, K, K), contiguous (kernel 2's IoU form
    takes it)."""
    aabb = torch.stack([boxes[..., 0] - boxes[..., 3] / 2,
                        boxes[..., 1] - boxes[..., 4] / 2,
                        boxes[..., 0] + boxes[..., 3] / 2,
                        boxes[..., 1] + boxes[..., 4] / 2], dim=-1)
    return box_utils.boxes_iou_normal(aabb, aabb).contiguous()
