"""PyTorch port vs the JAX package: training PV-RCNN, tiny
(``pvrcnn_tiny.yaml``), batch 2, f32 (``torch_port_two_stage_train_common``
builds both sides and says how the reference is patched in the test).

* ``points_in_boxes`` against ``points_in_boxes_jax``, rotated and
  zero-padded boxes, points inside, in the 0.2 m ring and far: indices
  bit-equal; ``enlarge_box3d`` bit-equal; the point targets equal (the
  three-class head's class ids; a one-class head's 1 for every
  foreground keypoint, where the reference's fault gives the class id);
  the point head's focal loss, its gradient and the MLP's train-mode BN
  statistics within 1e-5;
* the ROI targets on planted proposals (foreground, background, a
  different class, padded gts, most fg and bg scores tied at -1.0, where
  ``lax.top_k`` takes the lowest index): the picked rows, their gt rows
  and ``reg_valid`` equal, the classification targets within 1e-6; the
  residuals within 1e-5 of their scale; both losses and their gradients
  within 1e-5, but at logits of exactly 0, where the port's binary
  cross-entropy has the true derivative (max(x, 0) written (x + |x|) / 2,
  as ``loss_utils.sigmoid_focal_cls_loss`` has it) and the reference's
  clip and abs none;
* one training step from the reference's seeded init against
  ``jax.value_and_grad`` of the patched reference: loss and every tb term
  within 1e-5 relative, the BN statistics within 1e-5 of max(1, scale),
  every gradient within 1e-4 of its tensor's largest |g| or within twice
  the port's own move when the voxels' features are scaled by 1 +/- 1e-6
  noise, the latter for at most ``MAX_SPREAD_TENSORS`` tensors: on this
  batch a pre-ReLU value of ~1e-6 in the 3D backbone takes opposite
  signs in the two packages, and the first 17 convs' and BNs' gradients
  move by up to 2.4% of their scale under that noise, each within 1.001x
  of its distance from the reference (measured);
* the reference's two faults, pinned on it unpatched: the gradient of
  ``rcnn_reg_loss`` alone reaches the anchor head's ``conv_box`` through
  the rois (the port's proposals carry none), and its one-class point
  head turns the keypoints of every class but the first into negatives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models.dense_heads import point_head as jax_point_head
from q3d_tpu.models.roi_heads import RoIHeadTemplate as JaxRoIHeadTemplate
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.ops.roiaware_pool3d import points_in_boxes_jax
from q3d_tpu.utils import box_utils as jax_box_utils

import torch_port_anchor_common as common
import torch_port_two_stage_train_common as ts
from q3d_tpu_torch.models.dense_heads.point_head_simple import (
    PointHeadSimple, assign_point_targets)
from q3d_tpu_torch.models.roi_heads.roi_head_template import RoIHeadTemplate
from q3d_tpu_torch.ops.roiaware_pool3d import points_in_boxes
from q3d_tpu_torch.utils import box_utils
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_train_step import _np
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
NAME = "pvrcnn_tiny"
# of the 115 gradients (the biases before a BN apart), those that may take
# the port's own spread as their tolerance (17 measured)
MAX_SPREAD_TENSORS = 24


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng):
    """Two frames of 8 rows: six rotated boxes of classes 1-3, then two
    zero-padded rows."""
    gt = np.zeros((2, 8, 8), np.float32)
    for b in range(2):
        gt[b, :6, 0:2] = rng.uniform(-6, 6, (6, 2))
        gt[b, :6, 2] = rng.uniform(-1.5, 0.5, 6)
        gt[b, :6, 3:6] = rng.uniform(0.6, 4.0, (6, 3))
        gt[b, :6, 6] = rng.uniform(-np.pi, np.pi, 6)
        gt[b, :6, 7] = [1, 2, 3, 1, 2, 3]
    return gt


def _keypoints(rng, gt, n=300):
    """(2 * n, 4) [b, x, y, z]: per frame points inside its boxes, in
    their 0.2 m rings and anywhere."""
    rows = []
    for b in range(2):
        box = gt[b, rng.randint(0, 6, n)]
        local = rng.uniform(-0.5, 0.5, (n, 3)) * (box[:, 3:6] + 0.5)
        c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
        xyz = np.stack([local[:, 0] * c - local[:, 1] * s + box[:, 0],
                        local[:, 0] * s + local[:, 1] * c + box[:, 1],
                        local[:, 2] + box[:, 2]], 1)
        far = rng.rand(n) < 0.2
        xyz[far] = rng.uniform(-8, 8, (int(far.sum()), 3))
        rows.append(np.concatenate([np.full((n, 1), b), xyz], 1))
    return np.concatenate(rows).astype(np.float32)


def test_points_in_boxes_and_point_head_loss_match_reference(monkeypatch):
    rng = np.random.RandomState(0)
    gt = _boxes(rng)
    coords = _keypoints(rng, gt)
    for b in range(2):
        want = np.asarray(points_in_boxes_jax(jnp.asarray(coords[:, 1:4]),
                                              jnp.asarray(gt[b, :, :7])))
        got = points_in_boxes(_t(coords[:, 1:4]), _t(gt[b, :, :7]))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want >= 0).sum() > 100 and (want < 0).sum() > 50
        big = jax_box_utils.enlarge_box3d(jnp.asarray(gt[b, :, :7]),
                                          (0.2, 0.2, 0.2))
        np.testing.assert_array_equal(
            box_utils.enlarge_box3d(_t(gt[b, :, :7]), (0.2, 0.2, 0.2))
            .numpy(), np.asarray(big))
        np.testing.assert_array_equal(
            box_utils.enlarge_box3d(gt[b, :, :7], (0.2, 0.2, 0.2)),
            np.asarray(big))

    jcfg, pcfg = common.configs(NAME)
    for nc in (3, 1):
        jhead = jax_point_head.PointHeadSimple(
            model_cfg=jcfg.MODEL.POINT_HEAD, num_class=nc, input_channels=8)
        want, _ = jhead.apply({}, jnp.asarray(coords[:, 1:4]),
                              jnp.asarray(coords[:, 0].astype(np.int32)),
                              jnp.asarray(gt), method="assign_targets")
        want = np.asarray(want)
        got = assign_point_targets(_t(coords[:, 1:4]),
                                   _t(coords[:, 0]).long(), _t(gt), nc)
        assert set(np.unique(want)) == {-1, 0, 1, 2, 3}
        np.testing.assert_array_equal(got.numpy(), want if nc > 1
                                      else np.where(want > 0, 1, want))

    # the one-class head's loss and gradient, the reference patched
    ts.one_class_point_labels(monkeypatch)
    feats = rng.randn(len(coords), 64).astype(np.float32)
    jhead = jax_point_head.PointHeadSimple(
        model_cfg=jcfg.MODEL.POINT_HEAD, num_class=1, input_channels=64)
    batch = {"point_coords": jnp.asarray(coords), "gt_boxes": jnp.asarray(gt)}
    v = common._seeded_variables(jax.eval_shape(
        lambda k, f: jhead.init(k, dict(batch, point_features=f)),
        jax.random.PRNGKey(0), jnp.asarray(feats)), seed=2)

    def loss_fn(f):
        out, mut = jhead.apply(v, dict(batch, point_features=f), train=True,
                               mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"]["point_cls_loss"], mut)
    (jloss, (jterm, mut)), jgrad = jax.value_and_grad(
        loss_fn, has_aux=True)(jnp.asarray(feats))
    head = PointHeadSimple(pcfg.MODEL.POINT_HEAD, 64, 1)
    state = state_dict_from_jax({c: {"point_head": t}
                                 for c, t in _np(v).items()})
    head.load_state_dict({k.split(".", 1)[1]: t for k, t in state.items()},
                         strict=True)
    head.train()
    f = torch.tensor(feats, requires_grad=True)
    out = head({"point_features": f, "point_coords": _t(coords),
                "gt_boxes": _t(gt)})
    out["loss"].backward()
    assert float(jloss) > 0.1
    for mine in (out["loss"], out["tb_dict"]["point_cls_loss"]):
        assert abs(float(mine.detach()) - float(jterm)) \
            <= 1e-5 * float(jterm)
    jg = np.asarray(jgrad)
    assert np.abs(f.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    stats = state_dict_from_jax({"batch_stats": {"point_head": _np(
        mut["batch_stats"])}})
    buffers = dict(head.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name.split(".", 1)[1]] - s).abs().max())
        assert err <= 1e-5 * max(1.0, float(s.abs().max())), name


def _planted_rois(rng):
    """Proposals (2, 48, 7) and labels around gt boxes (2, 8, 8): per frame
    4 close copies of gts, 4 looser ones (IoU above and below
    REG_FG_THRESH), 4 of a gt with the wrong class, and the rest far from
    every gt (IoU 0)."""
    gt = _boxes(rng)
    rois = np.zeros((2, 48, 7), np.float32)
    labels = np.zeros((2, 48), np.int32)
    for b in range(2):
        rois[b, :, 0:2] = rng.uniform(20, 40, (48, 2))
        rois[b, :, 2] = -1.0
        rois[b, :, 3:6] = rng.uniform(0.6, 4.0, (48, 3))
        rois[b, :, 6] = rng.uniform(-np.pi, np.pi, 48)
        labels[b] = rng.randint(1, 4, 48)
        for j, slot in enumerate(rng.choice(48, 12, replace=False)):
            g = gt[b, j % 6]
            near = 0.1 if j < 4 else 0.5
            rois[b, slot] = g[:7] + np.r_[
                rng.uniform(-near, near, 3) * g[3:6],
                rng.uniform(-near, near, 3) * g[3:6], rng.uniform(-0.2, 0.2)]
            labels[b, slot] = g[7] if j < 8 else g[7] % 3 + 1
    return rois, labels, gt


def test_roi_targets_and_losses_match_reference():
    rng = np.random.RandomState(1)
    rois, labels, gt = _planted_rois(rng)
    jcfg, pcfg = common.configs(NAME)
    jhead = JaxRoIHeadTemplate(model_cfg=jcfg.MODEL.ROI_HEAD)
    want = [np.asarray(a) for a in jhead.apply(
        {}, jnp.asarray(rois), jnp.asarray(labels), jnp.asarray(gt),
        method="assign_targets")]
    head = RoIHeadTemplate(pcfg.MODEL.ROI_HEAD, 8)
    got = head.assign_targets(_t(rois), _t(labels), _t(gt))
    s_rois, s_gt, cls_t, reg_valid, _ = want
    np.testing.assert_array_equal(got["rois"].numpy(), s_rois)
    np.testing.assert_array_equal(got["gt"].numpy(), s_gt)
    np.testing.assert_array_equal(got["reg_valid"].numpy(), reg_valid)
    np.testing.assert_allclose(got["cls_target"].numpy(), cls_t, rtol=0,
                               atol=1e-6)
    # fg and bg slots both took rows tied at -1.0 (the lowest indices)
    assert 0 < reg_valid.sum(1).min() and reg_valid.sum(1).max() < 16
    assert ((cls_t > 0) & (cls_t < 1)).any() and (cls_t == 0).sum() > 16

    reg_t = np.asarray(jhead.apply({}, jnp.asarray(s_rois),
                                   jnp.asarray(s_gt),
                                   method="encode_targets"))
    mine = head.encode_targets(got["rois"], got["gt"]).numpy()
    assert np.abs(mine - reg_t).max() <= 1e-5 * np.abs(reg_t).max()

    cls_p = rng.randn(2, 32).astype(np.float32)
    cls_p[:, :3] = 0.0
    box_p = rng.randn(2, 32, 7).astype(np.float32) * 0.3

    def loss_fn(c, bx):
        cl, rg = jhead.apply({}, c, bx, tuple(jnp.asarray(a) for a in want),
                             method="get_loss")
        return cl + 2.0 * rg, (cl, rg)
    (_, (jcl, jrg)), (jgc, jgb) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(cls_p),
                                               jnp.asarray(box_p))
    c = torch.tensor(cls_p, requires_grad=True)
    bx = torch.tensor(box_p, requires_grad=True)
    cl, rg = head.get_loss(c, bx, got)
    (cl + 2.0 * rg).backward()
    assert float(jrg) > 0.01
    for ours, theirs in ((cl, jcl), (rg, jrg)):
        assert abs(float(ours.detach()) - float(theirs)) \
            <= 1e-5 * float(theirs)
    jgc, jgb = np.asarray(jgc), np.asarray(jgb)
    assert np.abs(bx.grad.numpy() - jgb).max() <= 1e-5 * np.abs(jgb).max()
    # at a logit of exactly 0 the port's BCE has the true derivative,
    # (sigmoid(0) - target) / n; the reference's clip and abs give none
    # there (-target / n)
    mine, t = c.grad.numpy(), got["cls_target"].numpy()
    zero = cls_p == 0
    assert np.abs(mine - jgc)[~zero].max() <= 1e-5 * np.abs(jgc).max()
    np.testing.assert_allclose(mine[zero], (0.5 - t[zero]) / cls_p.size,
                               rtol=1e-5)
    np.testing.assert_allclose(jgc[zero], -t[zero] / cls_p.size, rtol=1e-5)


@pytest.fixture(scope="module")
def two_stage():
    with pytest.MonkeyPatch.context() as mp:
        ts.patch_reference(mp)
        r = ts.build(NAME)
        r["want"] = ts.reference_step(r)
    return r


def test_train_step_matches_reference(two_stage):
    r = two_stage
    port = ts.port_step(r["port"], r["raw"])
    _, tb, _ = port
    assert set(tb) == ts.TB_KEYS | {"point_cls_loss"}
    assert tb["rcnn_reg_loss"] > 0.01 and tb["point_cls_loss"] > 0.01
    ts.check_step(r, r["want"], port, ts.self_spread(r["port"], r["raw"]),
                  MAX_SPREAD_TENSORS)
    # the proposals carry no gradient: conv_box's comes from the RPN alone
    assert r["port"].dense_head.conv_box.weight.grad is None


def test_reference_faults_pinned(two_stage, monkeypatch):
    """Unpatched, the reference's ``rcnn_reg_loss`` alone gives the anchor
    head's ``conv_box`` a gradient through the rois, and its point loss is
    another function: the keypoints of classes 2 and 3 are negatives of
    the one-class head; patched, both go, as the port has them."""
    r = two_stage
    params = r["vars"]["params"]
    other = {k: v for k, v in r["vars"].items() if k != "params"}
    batch = jax_load_data_to_device(dict(r["raw"], batch_size=2))

    def reg_loss(conv_box):
        p = {**params, "dense_head": {**params["dense_head"],
                                      "conv_box": conv_box}}
        out, _ = r["jmodel"].apply({"params": p, **other}, dict(batch),
                                   train=True, mutable=["batch_stats"])
        return out["tb_dict"]["rcnn_reg_loss"], out["tb_dict"][
            "point_cls_loss"]
    (reg, point), grad = jax.jit(jax.value_and_grad(reg_loss, has_aux=True))(
        params["dense_head"]["conv_box"])
    leak = max(float(np.abs(np.asarray(g)).max())
               for g in jax.tree_util.tree_leaves(grad))
    assert leak > 1e-3, leak
    _, tb_patched, _, _ = r["want"]
    assert abs(float(reg) - tb_patched["rcnn_reg_loss"]) \
        <= 1e-5 * tb_patched["rcnn_reg_loss"]
    # the unpatched one-hot: classes 2 and 3 count as positives, target 0
    assert abs(float(point) - tb_patched["point_cls_loss"]) \
        > 1e-3 * tb_patched["point_cls_loss"]
    assert np.array_equal(np.asarray(jax.nn.one_hot(jnp.asarray([1, 2, 3]),
                                                    2))[:, 1:],
                          [[1.0], [0.0], [0.0]])
