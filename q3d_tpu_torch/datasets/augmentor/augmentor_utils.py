"""Numpy geometric augmentation primitives (port of
``q3d_tpu/datasets/augmentor/augmentor_utils.py``): global flips about x
and y, rotation about z, scaling and translation; per-object translation,
rotation and scaling; scene and per-object frustum dropout; and SE-SSD's
pyramid dropout, sparsify and swap.  Each applies to the points and the
(7+)-column gt boxes (centre, size, heading, optional velocity) together.

Every random draw comes from the ``rng`` argument (a
``np.random.RandomState``), in the reference's order of draws; the
reference draws from numpy's global state, so a RandomState seeded as
``np.random.seed`` was gives the same stream.  A draw that is pinned
(``force=``, ``angle=``, ``scale=``) takes nothing from ``rng``.
"""

import numpy as np

from ...utils import box_utils, common_utils


def random_flip_along_x(gt_boxes, points, rng, enable_prob=0.5, force=None):
    """Flip y -> -y. gt heading r -> -r; velocity vy -> -vy."""
    enable = rng.rand() < enable_prob if force is None else force
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points, enable


def random_flip_along_y(gt_boxes, points, rng, enable_prob=0.5, force=None):
    """Flip x -> -x. heading r -> -(r + pi); velocity vx -> -vx."""
    enable = rng.rand() < enable_prob if force is None else force
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points, enable


def global_rotation(gt_boxes, points, rot_range, rng, angle=None):
    if angle is None:
        angle = rng.uniform(rot_range[0], rot_range[1])
    points = common_utils.rotate_points_along_z(
        points[None].astype(np.float32), np.array([angle], np.float32))[0]
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = common_utils.rotate_points_along_z(
        gt_boxes[None, :, 0:3].astype(np.float32),
        np.array([angle], np.float32))[0]
    gt_boxes[:, 6] += angle
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate([gt_boxes[:, 7:9],
                              np.zeros((len(gt_boxes), 1), np.float32)], axis=1)
        vel = common_utils.rotate_points_along_z(
            vel[None], np.array([angle], np.float32))[0]
        gt_boxes[:, 7:9] = vel[:, 0:2]
    return gt_boxes, points, angle


def global_scaling(gt_boxes, points, scale_range, rng, scale=None):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points, 1.0
    if scale is None:
        scale = rng.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] *= scale
    return gt_boxes, points, scale


def global_translation(gt_boxes, points, noise_std, rng):
    if isinstance(noise_std, (int, float)):
        noise_std = [noise_std] * 3
    t = np.array([rng.normal(0, s) for s in noise_std], np.float32)
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points, t


# ----------------------- local (per-object) transforms -----------------------
# One object after another, as the reference: overlapping boxes see each
# other's moves; the membership test is vectorised over the points.

def get_points_in_box(points, gt_box, margin=1e-1):
    """Boolean mask of the points inside a (7,) rotated box (z without a
    margin, x and y with 0.1 m)."""
    shift = points[:, 0:3] - gt_box[0:3]
    cosa, sina = np.cos(-gt_box[6]), np.sin(-gt_box[6])
    local_x = shift[:, 0] * cosa - shift[:, 1] * sina
    local_y = shift[:, 0] * sina + shift[:, 1] * cosa
    return ((np.abs(shift[:, 2]) <= gt_box[5] / 2.0)
            & (np.abs(local_x) <= gt_box[3] / 2.0 + margin)
            & (np.abs(local_y) <= gt_box[4] / 2.0 + margin))


def _local_translation(gt_boxes, points, offset_range, axis, rng):
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    for idx in range(len(gt_boxes)):
        offset = rng.uniform(offset_range[0], offset_range[1])
        mask = get_points_in_box(points, gt_boxes[idx])
        points[mask, axis] += offset
        gt_boxes[idx, axis] += offset
    return gt_boxes, points


def random_local_translation_along_x(gt_boxes, points, offset_range, rng):
    return _local_translation(gt_boxes, points, offset_range, 0, rng)


def random_local_translation_along_y(gt_boxes, points, offset_range, rng):
    return _local_translation(gt_boxes, points, offset_range, 1, rng)


def random_local_translation_along_z(gt_boxes, points, offset_range, rng):
    return _local_translation(gt_boxes, points, offset_range, 2, rng)


def local_scaling(gt_boxes, points, scale_range, rng):
    """Scale each object's points about its centre."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    for idx in range(len(gt_boxes)):
        s = rng.uniform(scale_range[0], scale_range[1])
        mask = get_points_in_box(points, gt_boxes[idx])
        points[mask, 0:3] = (points[mask, 0:3] - gt_boxes[idx, 0:3]) * s \
            + gt_boxes[idx, 0:3]
        gt_boxes[idx, 3:6] *= s
    return gt_boxes, points


def local_rotation(gt_boxes, points, rot_range, rng):
    """Rotate each object and its points about its own centre; velocity
    columns rotate with it."""
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    for idx in range(len(gt_boxes)):
        angle = rng.uniform(rot_range[0], rot_range[1])
        mask = get_points_in_box(points, gt_boxes[idx])
        c = gt_boxes[idx, 0:3].copy()
        rel = (points[mask, 0:3] - c).astype(np.float32)
        rel = common_utils.rotate_points_along_z(
            rel[None], np.array([angle], np.float32))[0]
        points[mask, 0:3] = rel + c
        gt_boxes[idx, 6] += angle
        if gt_boxes.shape[1] > 8:
            vel = np.array([[gt_boxes[idx, 7], gt_boxes[idx, 8], 0.0]],
                           np.float32)
            vel = common_utils.rotate_points_along_z(
                vel[None], np.array([angle], np.float32))[0]
            gt_boxes[idx, 7:9] = vel[0, 0:2]
    return gt_boxes, points


# ----------------------------- frustum dropout ------------------------------

_FRUSTUM_AXIS = {"top": (2, +1), "bottom": (2, -1),
                 "left": (1, +1), "right": (1, -1)}


def _global_frustum_dropout(gt_boxes, points, intensity_range, direction,
                            rng):
    """Drop everything beyond a slab of the scene's extent along z
    (top/bottom) or y (left/right)."""
    axis, sign = _FRUSTUM_AXIS[direction]
    intensity = rng.uniform(intensity_range[0], intensity_range[1])
    if len(points) == 0:
        return gt_boxes, points
    lo, hi = points[:, axis].min(), points[:, axis].max()
    if sign > 0:
        thr = hi - intensity * (hi - lo)
        keep_p = points[:, axis] < thr
        keep_b = gt_boxes[:, axis] < thr
    else:
        thr = lo + intensity * (hi - lo)
        keep_p = points[:, axis] > thr
        keep_b = gt_boxes[:, axis] > thr
    return gt_boxes[keep_b], points[keep_p]


def global_frustum_dropout_top(gt_boxes, points, intensity_range, rng):
    return _global_frustum_dropout(gt_boxes, points, intensity_range, "top",
                                   rng)


def global_frustum_dropout_bottom(gt_boxes, points, intensity_range, rng):
    return _global_frustum_dropout(gt_boxes, points, intensity_range,
                                   "bottom", rng)


def global_frustum_dropout_left(gt_boxes, points, intensity_range, rng):
    return _global_frustum_dropout(gt_boxes, points, intensity_range, "left",
                                   rng)


def global_frustum_dropout_right(gt_boxes, points, intensity_range, rng):
    return _global_frustum_dropout(gt_boxes, points, intensity_range,
                                   "right", rng)


def _local_frustum_dropout(gt_boxes, points, intensity_range, direction, rng):
    """Per object: drop its points beyond a slab of the box's extent."""
    axis, sign = _FRUSTUM_AXIS[direction]
    for idx in range(len(gt_boxes)):
        box = gt_boxes[idx]
        # extent along the slab axis: dz for top/bottom, dy for left/right
        c = box[axis]
        d = box[5] if axis == 2 else box[4]
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        mask = get_points_in_box(points, box)
        if sign > 0:
            thr = (c + d / 2) - intensity * d
            drop = mask & (points[:, axis] >= thr)
        else:
            thr = (c - d / 2) + intensity * d
            drop = mask & (points[:, axis] <= thr)
        points = points[~drop]
    return gt_boxes, points


def local_frustum_dropout_top(gt_boxes, points, intensity_range, rng):
    return _local_frustum_dropout(gt_boxes, points, intensity_range, "top",
                                  rng)


def local_frustum_dropout_bottom(gt_boxes, points, intensity_range, rng):
    return _local_frustum_dropout(gt_boxes, points, intensity_range,
                                  "bottom", rng)


def local_frustum_dropout_left(gt_boxes, points, intensity_range, rng):
    return _local_frustum_dropout(gt_boxes, points, intensity_range, "left",
                                  rng)


def local_frustum_dropout_right(gt_boxes, points, intensity_range, rng):
    return _local_frustum_dropout(gt_boxes, points, intensity_range, "right",
                                  rng)


# --------------------------- pyramid augmentation ---------------------------
# SE-SSD's per-face frustum ("pyramid") dropout, sparsify and swap.

_PYRAMID_ORDERS = np.array([
    [0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
    [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3],
])


def get_pyramids(boxes):
    """(N, 7+) -> (N, 6, 15): per box, 6 face pyramids of (apex + 4 base
    corners) x 3 coordinates."""
    corners = box_utils.boxes_to_corners_3d(
        np.asarray(boxes[:, :7], np.float32))            # (N, 8, 3)
    pyramid_list = []
    for order in _PYRAMID_ORDERS:
        pyr = np.concatenate([boxes[:, 0:3]] +
                             [corners[:, o, :] for o in order], axis=1)
        pyramid_list.append(pyr[:, None, :])
    return np.concatenate(pyramid_list, axis=1)          # (N, 6, 15)


def _one_hot(x, num_class):
    oh = np.zeros((len(x), num_class))
    oh[np.arange(len(x)), x] = 1
    return oh


def _in_hull(points, hull_pts):
    """Convex-hull membership via a Delaunay triangulation."""
    from scipy.spatial import Delaunay, QhullError
    try:
        hull = Delaunay(hull_pts)
    except QhullError:
        return np.zeros(len(points), bool)
    return hull.find_simplex(points) >= 0


def points_in_pyramids_mask(points, pyramids):
    """(P, *, 15) pyramids -> (N, number of pyramids) bool membership."""
    pyramids = pyramids.reshape(-1, 5, 3)
    flags = np.zeros((points.shape[0], pyramids.shape[0]), bool)
    for i, pyr in enumerate(pyramids):
        flags[:, i] = _in_hull(points[:, 0:3], pyr)
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, rng, pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    drop_idx = rng.randint(0, 6, pyramids.shape[0])
    drop_box = rng.uniform(0, 1, pyramids.shape[0]) <= dropout_prob
    if drop_box.sum() != 0:
        drop_mask = (drop_box[:, None] * _one_hot(drop_idx, 6)) > 0
        masks = points_in_pyramids_mask(points, pyramids[drop_mask])
        points = points[~masks.any(-1)]
    pyramids = pyramids[~drop_box]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, rng,
                           pyramids=None):
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    if pyramids.shape[0] > 0:
        sp_idx = rng.randint(0, 6, pyramids.shape[0])
        sp_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
        sp_mask = (sp_box[:, None] * _one_hot(sp_idx, 6)) > 0
        sampled = pyramids[sp_mask]
        masks = points_in_pyramids_mask(points, sampled)
        valid = masks.sum(0) > max_num_pts
        if valid.any():
            masks = masks[:, valid]
            remain = points[~masks.any(-1)]
            kept = []
            for i in range(masks.shape[1]):
                inside = points[masks[:, i]]
                sel = rng.choice(len(inside), size=max_num_pts,
                                 replace=False)
                kept.append(inside[sel])
            points = np.concatenate([remain] + kept, axis=0)
        pyramids = pyramids[~sp_box]
    return gt_boxes, points, pyramids


def _pyramid_frame(pyr):
    """A (15,) pyramid's frame: base point, the base's centre, two base
    edge vectors and the apex direction."""
    base = pyr[3:6]
    surface_center = (pyr[3:6] + pyr[6:9] + pyr[9:12] + pyr[12:15]) / 4.0
    v0 = pyr[6:9] - base
    v1 = pyr[12:15] - base
    v2 = pyr[0:3] - surface_center
    return base, surface_center, v0, v1, v2


def _points_ratio(points, pyr):
    base, sc, v0, v1, v2 = _pyramid_frame(pyr)
    alphas = ((points[:, 0:3] - base) * v0).sum(-1) / (v0 ** 2).sum()
    betas = ((points[:, 0:3] - base) * v1).sum(-1) / (v1 ** 2).sum()
    gammas = ((points[:, 0:3] - sc) * v2).sum(-1) / (v2 ** 2).sum()
    return alphas, betas, gammas


def _recover_by_ratio(ratios, pyr):
    alphas, betas, gammas = ratios
    base, sc, v0, v1, v2 = _pyramid_frame(pyr)
    return (alphas[:, None] * v0 + betas[:, None] * v1) + base \
        + gammas[:, None] * v2


def _norm_intensity(p):
    """Column 3 (the intensity) min-max normalised -> (values, min, max)."""
    lo = p[:, 3:4].min(initial=0.0)
    hi = p[:, 3:4].max(initial=0.0)
    return (p[:, 3:4] - lo) / np.clip(hi - lo, 1e-6, None), lo, hi


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, rng,
                       pyramids=None):
    """Swap the point sets of matching face pyramids between two objects,
    each re-expressed in the other pyramid's frame; the intensity is
    min-max renormalised into the receiving pyramid's range (column 3, the
    intensity, on clouds of more than 4 columns too; further columns swap
    as they are)."""
    if pyramids is None:
        pyramids = get_pyramids(gt_boxes).reshape(-1, 6, 5, 3)
    swap_box = rng.uniform(0, 1, pyramids.shape[0]) <= prob
    if swap_box.sum() == 0:
        return gt_boxes, points
    masks = points_in_pyramids_mask(points, pyramids)
    point_nums = masks.sum(0).reshape(pyramids.shape[0], 6)
    nonzero = point_nums > max_num_pts
    selected = nonzero * swap_box[:, None]
    if selected.sum() == 0:
        return gt_boxes, points
    index_i, index_j = np.nonzero(selected)
    sel_idx = [rng.choice(index_j[index_i == i])
               if e and (index_i == i).any() else 0
               for i, e in enumerate(swap_box)]
    sel_mask = (selected * _one_hot(sel_idx, 6)) == 1
    to_swap = pyramids[sel_mask]
    ii, jj = np.nonzero(sel_mask)
    nonzero[sel_mask] = False
    partner_i = np.array([
        rng.choice(np.where(nonzero[:, j])[0])
        if len(np.where(nonzero[:, j])[0]) > 0 else ii[k]
        for k, j in enumerate(jj.tolist())])
    swapped = pyramids[partner_i, jj]
    pair = np.concatenate([to_swap, swapped], axis=0)
    pair_masks = points_in_pyramids_mask(points, pair)
    remain = points[~pair_masks.any(-1)]
    n = len(to_swap)
    out = []
    for i in range(n):
        a_pts = points[pair_masks[:, i]]
        b_pts = points[pair_masks[:, i + n]]
        pa, pb = to_swap[i].reshape(15), swapped[i].reshape(15)
        new_a = _recover_by_ratio(_points_ratio(b_pts, pb), pa)
        new_b = _recover_by_ratio(_points_ratio(a_pts, pa), pb)
        if points.shape[1] > 3:
            ra, lo_a, hi_a = _norm_intensity(a_pts)
            rb, lo_b, hi_b = _norm_intensity(b_pts)
            new_a = np.concatenate([new_a, rb * (hi_a - lo_a) + lo_a],
                                   axis=1)
            new_b = np.concatenate([new_b, ra * (hi_b - lo_b) + lo_b],
                                   axis=1)
            if points.shape[1] > 4:
                new_a = np.concatenate([new_a, b_pts[:, 4:]], axis=1)
                new_b = np.concatenate([new_b, a_pts[:, 4:]], axis=1)
        out.append(new_a)
        out.append(new_b)
    points = np.concatenate([remain] + out, axis=0).astype(points.dtype)
    return gt_boxes, points
