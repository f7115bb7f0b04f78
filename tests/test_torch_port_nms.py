"""PyTorch port vs the JAX package: rotated BEV IoU and kernel 2's function
(greedy NMS suppression, which ``pallas_nms.py`` runs on the TPU), in both
of the port's forms: from an IoU matrix and from the boxes.

Keep masks and NMS selections must be exactly equal; the IoU agrees within
1e-5 (the same float32 formula, evaluated by two libraries).  The IoU and
the boxes form live in ``test_torch_port_nms_boxes.py``, so that each file
keeps at most 5 tests and ``--dist loadfile`` dispatches
``test_accuracy_regression.py`` early.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.ops.iou3d_nms import iou3d_nms_utils as jax_iou
from q3d_tpu.ops.iou3d_nms import pallas_nms

from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as port_nms
from q3d_tpu_torch.ops.iou3d_nms import iou3d_nms_utils as port_iou
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

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


# a seeded PV-RCNN's proposal pair on the card (its BEV corners as the
# card's sin / cos gave them): box j 51.7 x 0.00022 m, box i 33.6 x
# 1.9e-6 m, whose corners 1 and 2 coincide and 0 and 3 are one ulp apart
DEGENERATE_PAIR = (
    [[80.71006774902344, 33.170570373535156],
     [70.947998046875, -17.62371253967285],
     [70.94821166992188, -17.623754501342773],
     [80.71028137207031, 33.1705322265625]],
    [[30.93077850341797, 65.24694061279297],
     [54.57554626464844, 41.308204650878906],
     [54.57554626464844, 41.308204650878906],
     [30.9307804107666, 65.24694061279297]])


def kernel_circle(q):
    """csrc/greedy_nms.cu's ``circle``: the corners' mean, the
    circumscribed radius inflated by 0.05% + 5 mm, infinite for a quad that
    does not turn strictly left at every corner."""
    o = (((q[..., 0, :] + q[..., 1, :]) + q[..., 2, :]) + q[..., 3, :]) * 0.25
    r2 = ((q - o[..., None, :]) ** 2).sum(-1).amax(-1)
    e = torch.roll(q, -1, dims=-2) - q
    en = torch.roll(e, -1, dims=-2)
    convex = ((e[..., 0] * en[..., 1] - e[..., 1] * en[..., 0]) > 0).all(-1)
    return o, torch.where(convex, r2.sqrt() * 1.0005 + 0.005, torch.inf)


def test_degenerate_quads_are_never_skipped():
    """A quad whose corners rounded onto each other is no convex quad: its
    half-planes leave a wedge open, and the formula gives this pair, 56 m
    apart and outside each other's circles, an overlap of 9.5e-7 (IoU
    8.3e-5, above a threshold of 0).  The kernel's circle test gives such
    a quad an infinite radius, so the pair is evaluated, as the plain
    version evaluates it; every proper box keeps a finite radius."""
    qa, qb = (torch.tensor(c) for c in DEGENERATE_PAIR)
    overlap = port_iou._rotated_overlap_quads(qa, qb)
    assert float(overlap) > 0
    (oa, ra), (ob, rb) = kernel_circle(qa), kernel_circle(qb)
    dist = float(((ob - oa) ** 2).sum().sqrt())
    raw = [float((((q - o) ** 2).sum(-1).amax().sqrt()) * 1.0005 + 0.005)
           for q, o in ((qa, oa), (qb, ob))]
    assert dist > sum(raw)                    # the circles alone are apart
    assert torch.isfinite(ra) and not torch.isfinite(rb)
    rng = np.random.RandomState(6)
    boxes = _random_boxes(rng, 5000, spread=60.0)
    boxes[:, 3:5] = rng.uniform(1e-3, 12.0, (5000, 2))
    _, r = kernel_circle(port_iou.box_utils.boxes_to_corners_bev(
        torch.from_numpy(boxes)))
    assert bool(torch.isfinite(r).all())


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
        k = port_nms.MAX_K + 1
        port_nms.greedy_suppress_boxes_cuda(
            torch.zeros(1, k, 4, 2), torch.zeros(1, k),
            torch.ones(1, k, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="unknown impl"):
        port_nms.greedy_nms_boxes(boxes, valid, 0.5, impl="xla")


@pytest.mark.parametrize("form", ["iou", "boxes"])
def test_greedy_nms_wrappers_take_k_up_to_4096(form):
    """Both entries take 0 < K <= MAX_K = 9216 (144 mask words a row; the
    name is from when they stopped at 4096) and raise above it; nothing
    falls back to the plain version."""
    assert port_nms.MAX_K == 9216
    for k, ok in ((4096, True), (9000, True), (9216, True), (9217, False)):
        valid = torch.ones(1, k, dtype=torch.bool)
        if form == "iou":
            # left unfilled: the checks read its shape only
            call = lambda: port_nms.greedy_suppress_cuda(  # noqa: E731
                torch.empty(1, k, k), valid, 0.5)
        else:
            call = lambda: port_nms.greedy_suppress_boxes_cuda(  # noqa: E731
                torch.zeros(1, k, 4, 2), torch.zeros(1, k), valid, 0.5)
        # past the K check, a CPU tensor is refused: the kernel or nothing
        with pytest.raises(ValueError, match="CUDA tensor" if ok
                           else r"K must be in \[1, 9216\] \(got 9217\)"):
            call()
