"""PyTorch port vs the JAX package: rotated BEV IoU and kernel 2's function
(greedy NMS suppression, which ``pallas_nms.py`` runs on the TPU), in both
of the port's forms: from an IoU matrix and from the boxes.

Keep masks and NMS selections must be exactly equal; the IoU agrees within
1e-5 (the same float32 formula, evaluated by two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.ops.iou3d_nms import iou3d_nms_utils as jax_iou
from q3d_tpu.ops.iou3d_nms import pallas_nms

from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as port_nms
from q3d_tpu_torch.ops.iou3d_nms import iou3d_nms_utils as port_iou

torch.set_num_threads(2)


def _random_iou(rng, k):
    """A (K, K) IoU-like matrix: symmetric-ish values in [0, 1) with a
    dense band of overlaps, so suppression chains form."""
    a = rng.rand(k, k).astype(np.float32)
    a = a * (rng.rand(k, k) < 0.3)
    return a


@pytest.mark.parametrize("k,thresh", [(128, 0.2), (128, 0.5), (256, 0.1),
                                      (256, 0.7)])
def test_greedy_suppress_matches_pallas_kernel(k, thresh):
    rng = np.random.RandomState(k + int(thresh * 10))
    sets = [(_random_iou(rng, k), rng.rand(k) > 0.1) for _ in range(3)]
    ref = np.stack([np.asarray(pallas_nms.greedy_suppress_pallas(
        jnp.asarray(iou), jnp.asarray(valid), thresh, interpret=True))
        for iou, valid in sets])
    iou = torch.from_numpy(np.stack([s[0] for s in sets]))
    valid = torch.from_numpy(np.stack([s[1] for s in sets]))
    keep = port_nms.greedy_nms(iou, valid, thresh)
    np.testing.assert_array_equal(keep.numpy(), ref)
    # the reference's wavefront sweep, which the JAX model runs, agrees too
    wave = np.asarray(jax_iou._greedy_suppress_wavefront(
        jnp.asarray(sets[0][0]), jnp.asarray(sets[0][1]), thresh))
    np.testing.assert_array_equal(keep[0].numpy(), wave)


def test_greedy_suppress_padded_k_matches_reference():
    """K = 200 candidates: the reference pads to 256 inside
    ``greedy_suppress``; the port pads in ``candidate_iou``-style with zero
    IoU and invalid rows."""
    rng = np.random.RandomState(11)
    k, kp, thresh = 200, 256, 0.3
    iou, valid = _random_iou(rng, k), rng.rand(k) > 0.2
    ref = np.asarray(pallas_nms.greedy_suppress(jnp.asarray(iou),
                                                jnp.asarray(valid), thresh))
    iou_p = np.zeros((1, kp, kp), np.float32)
    iou_p[0, :k, :k] = iou
    valid_p = np.zeros((1, kp), bool)
    valid_p[0, :k] = valid
    keep = port_nms.greedy_nms(torch.from_numpy(iou_p),
                               torch.from_numpy(valid_p), thresh)
    np.testing.assert_array_equal(keep[0, :k].numpy(), ref)
    assert not keep[0, k:].any()


def _random_boxes(rng, n, spread=6.0):
    """(N, 7) boxes [x, y, z, dx, dy, dz, heading], crowded so many overlap."""
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_boxes_iou_bev_matches_reference():
    rng = np.random.RandomState(0)
    a, b = _random_boxes(rng, 96), _random_boxes(rng, 80)
    b[:10] = a[:10]                                   # identical pairs
    b[10:20, :6] = a[10:20, :6]                       # same box, rotated
    ref = np.asarray(jax_iou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    ours = port_iou.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    assert ours.shape == ref.shape and (ref > 0.1).sum() > 50
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # batched over sets, as the port's NMS calls it
    batched = port_iou.boxes_iou_bev(torch.from_numpy(np.stack([a, a])),
                                     torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[1].numpy(), ours.numpy())


@pytest.mark.parametrize("presorted", [False, True])
def test_nms_bev_matches_reference(presorted):
    """Whole rotated NMS on random candidates: the same selected indices and
    validity, set by set (pre_maxsize 150 pads K to 256)."""
    rng = np.random.RandomState(3)
    s, n = 3, 180
    boxes = np.stack([_random_boxes(rng, n) for _ in range(s)])
    scores = rng.rand(s, n).astype(np.float32)
    scores[:, 5:9] = scores[:, 4:5]                   # exact ties
    valid = rng.rand(s, n) > 0.15
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        boxes = np.take_along_axis(boxes, order[..., None], 1)
        scores = np.take_along_axis(scores, order, 1)
        valid = np.take_along_axis(valid, order, 1)
    idx, sel_valid = port_iou.nms_bev(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.2,
        pre_maxsize=150, post_maxsize=120, score_valid=torch.from_numpy(valid),
        presorted=presorted)
    for i in range(s):
        r_idx, r_valid = jax_iou.nms_bev(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.2,
            pre_maxsize=150, post_maxsize=120,
            score_valid=jnp.asarray(valid[i]), presorted=presorted)
        np.testing.assert_array_equal(sel_valid[i].numpy(), np.asarray(r_valid))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(r_idx))
    # some candidates were suppressed, and the post-NMS cap did not bind
    assert 0 < int(sel_valid.sum()) < s * 120


def test_greedy_nms_wrapper_rejects_what_the_kernel_does_not_take():
    iou, valid = torch.zeros(1, 8, 8), torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_nms.greedy_suppress_cuda(iou, valid, 0.5)
    with pytest.raises(ValueError, match="unknown impl"):
        port_nms.greedy_nms(iou, valid, 0.5, impl="xla")


def _crowded_sets(rng, s, k):
    """(S, K, 7) crowded boxes with identical and rotated duplicates, and a
    valid mask with some invalid rows."""
    boxes = np.stack([_random_boxes(rng, k, spread=4.0) for _ in range(s)])
    boxes[:, 10:20] = boxes[:, 0:10]                  # identical duplicates
    boxes[:, 20:30, :6] = boxes[:, 30:40, :6]         # same box, rotated
    return boxes, rng.rand(s, k) > 0.15


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.6])
def test_greedy_nms_boxes_matches_reference(thresh):
    """The boxes form (IoU computed inside kernel 2 on the card; here its
    plain version) equals the JAX model's sweep over the JAX IoU: K = 200
    candidates padded with zero boxes to 256."""
    rng = np.random.RandomState(int(thresh * 100))
    s, k, kp = 2, 200, 256
    boxes, valid = _crowded_sets(rng, s, k)
    boxes_p = np.zeros((s, kp, 7), np.float32)
    boxes_p[:, :k] = boxes
    valid_p = np.zeros((s, kp), bool)
    valid_p[:, :k] = valid
    keep = port_nms.greedy_nms_boxes(torch.from_numpy(boxes_p),
                                     torch.from_numpy(valid_p), thresh)
    assert keep.shape == (s, kp) and not keep[:, k:].any()
    for i in range(s):
        b = jnp.asarray(boxes[i])
        ref = np.asarray(jax_iou._greedy_suppress_wavefront(
            jax_iou.boxes_iou_bev(b, b), jnp.asarray(valid[i]), thresh))
        np.testing.assert_array_equal(keep[i, :k].numpy(), ref)
        # duplicates suppress each other, and not every valid box survives
        assert 0 < int(keep[i].sum()) < int(valid[i].sum())


def test_apart_circles_give_exactly_zero_iou():
    """Kernel 2's boxes form skips a pair whose circumscribed circles,
    each inflated by 0.05% + 5 mm, are apart: it relies on the formula
    giving exactly 0 there.  Pairs just outside that distance, anywhere in
    a +-60 m scene, at any size and heading."""
    rng = np.random.RandomState(5)
    n = 20000
    a, b = np.zeros((n, 7), np.float32), np.zeros((n, 7), np.float32)
    a[:, 0:2] = rng.uniform(-60, 60, (n, 2))
    a[:, 3:5] = rng.uniform(0.2, 12.0, (n, 2))
    b[:, 3:5] = rng.uniform(0.2, 12.0, (n, 2))
    a[:, 6], b[:, 6] = rng.uniform(-np.pi, np.pi, (2, n))
    reach = 0.5 * (np.hypot(a[:, 3], a[:, 4]) + np.hypot(b[:, 3], b[:, 4]))
    dist = reach * 1.0005 + 0.01 + rng.choice([0.0, 1e-4, 1e-2], n)
    angle = rng.uniform(0, 2 * np.pi, n)
    b[:, 0] = a[:, 0] + dist * np.cos(angle)
    b[:, 1] = a[:, 1] + dist * np.sin(angle)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    qa, qb = (port_iou.box_utils.boxes_to_corners_bev(t) for t in (ta, tb))

    def circle(q):                  # as csrc/greedy_nms.cu's load_box
        o = (q[:, 0] + q[:, 1] + q[:, 2] + q[:, 3]) * 0.25
        r2 = ((q - o[:, None]) ** 2).sum(-1).amax(-1)
        return o, r2.sqrt() * 1.0005 + 0.005
    (oa, ra), (ob, rb) = circle(qa), circle(qb)
    apart = ((ob - oa) ** 2).sum(-1) > (ra + rb) ** 2
    assert int(apart.sum()) > n // 2
    overlap = port_iou._rotated_overlap_quads(qa, qb)
    iou = overlap / (ta[:, 3] * ta[:, 4] + tb[:, 3] * tb[:, 4]
                     - overlap).clamp(min=1e-6)
    assert int((overlap[apart] != 0).sum()) == 0
    assert int((iou[apart] != 0).sum()) == 0


def test_greedy_nms_boxes_wrapper_rejects_what_the_kernel_does_not_take():
    boxes = torch.zeros(2, 8, 7)
    valid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_nms.greedy_nms_boxes(boxes, valid, 0.5, impl="cuda")
    corners, areas = port_nms.bev_corners_areas(boxes)
    assert corners.shape == (2, 8, 4, 2) and areas.shape == (2, 8)
    with pytest.raises(ValueError, match=r"corners must be .*\(S, K, 4, 2\)"):
        port_nms.greedy_suppress_boxes_cuda(corners[..., :1, :].contiguous(),
                                            areas, valid, 0.5)
    with pytest.raises(ValueError, match="areas must be"):
        port_nms.greedy_suppress_boxes_cuda(corners, areas[:, :4], valid, 0.5)
    with pytest.raises(ValueError, match="valid must be"):
        port_nms.greedy_suppress_boxes_cuda(corners, areas, valid[:1], 0.5)
    with pytest.raises(ValueError, match="K must be"):
        big = torch.zeros(1, 2049, 4, 2)
        port_nms.greedy_suppress_boxes_cuda(
            big, torch.zeros(1, 2049), torch.ones(1, 2049, dtype=torch.bool),
            0.5)
    with pytest.raises(ValueError, match="unknown impl"):
        port_nms.greedy_nms_boxes(boxes, valid, 0.5, impl="xla")

