"""PyTorch port vs the JAX package: the rotated BEV IoU and greedy NMS
from boxes (moved out of ``test_torch_port_nms.py`` so that each file keeps
at most 5 tests and ``--dist loadfile`` dispatches
``test_accuracy_regression.py`` early).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.ops.iou3d_nms import iou3d_nms_utils as jax_iou

from q3d_tpu_torch.ops.iou3d_nms import greedy_nms as port_nms
from q3d_tpu_torch.ops.iou3d_nms import iou3d_nms_utils as port_iou

from test_torch_port_nms import _crowded_sets, _random_boxes
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


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
