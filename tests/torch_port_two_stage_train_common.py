"""Shared body of the two-stage training parity tests
(``test_torch_port_pvrcnn_train.py``, ``test_torch_port_voxelrcnn_train.py``):
the tiny PV-RCNN or Voxel R-CNN on both sides from one seeded init, a
training batch with gt boxes planted on the port's proposals, and one
training step of each package.

The reference is patched in the test only, where it departs from what the
port does on purpose (``ROADMAP.md`` §3):
  * its anchor assigner's targets are permuted into the head's anchor
    order (``test_torch_port_anchor_train._in_head_order``);
  * its proposal layer's rois stop the gradient (``jax.lax.stop_gradient``,
    as OpenPCDet computes proposals under ``torch.no_grad``): unpatched,
    the ROI head's losses flow back through the rois into the anchor
    head's box branch;
  * its class-agnostic point head takes every foreground keypoint as
    positive (label 1), as OpenPCDet's does; unpatched, its one-hot of the
    gt's class id makes every keypoint of a class but the first a negative
    that still counts among the positives.

Seeded weights leave every proposal far from the synthetic gt boxes (no
roi reaches REG_FG_THRESH, so ``rcnn_reg_loss`` would be 0): after the
frames' own objects, each frame's gt rows get ``PLANTED`` boxes made from
its first proposals of a training forward (the port's; the reference's
are the same keep set), shifted and grown a little, with the proposal's
class, so that the ROI head's regression and the sampling's foreground
share have work.  Planted boxes are targets only: the points stay as they
are.
"""

import copy

import jax
import numpy as np

from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.dense_heads import point_head as jax_point_head
from q3d_tpu.models.detectors import detector3d_template as jax_template

import torch_port_anchor_common as common
from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.train_utils import MODEL_KEYS, train_step
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_anchor_train import _frames, _in_head_order
from test_torch_port_train_step import SGD, _np

LOSS_RTOL, GRAD_RTOL, STATS_TOL = 1e-5, 1e-4, 1e-5
SGD_NO_CLIP = {**SGD, "GRAD_NORM_CLIP": 0}
PLANTED = 6
TB_KEYS = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
           "rcnn_cls_loss", "rcnn_reg_loss"}


def stop_proposal_gradient(monkeypatch):
    """The reference's proposal layer with its rois (and scores) cut from
    the gradient, in the test only."""
    real = jax_template.Detector3DTemplate.proposal_layer

    def proposals(self, batch_dict, nms_config):
        out = real(self, batch_dict, nms_config)
        for k in ("rois", "roi_scores"):
            out[k] = jax.lax.stop_gradient(out[k])
        return out
    monkeypatch.setattr(jax_template.Detector3DTemplate, "proposal_layer",
                        proposals)


def one_class_point_labels(monkeypatch):
    """The reference's point targets with every foreground keypoint of a
    one-class head labelled 1, in the test only."""
    real = jax_point_head.PointHeadTemplate.assign_targets

    def assign(self, xyz, batch_idx, gt_boxes, *args, **kw):
        labels, box_idx = real(self, xyz, batch_idx, gt_boxes, *args, **kw)
        if self.num_class == 1:
            labels = jax.numpy.where(labels > 0, 1, labels)
        return labels, box_idx
    monkeypatch.setattr(jax_point_head.PointHeadTemplate, "assign_targets",
                        assign)


def patch_reference(monkeypatch):
    _in_head_order(monkeypatch)
    stop_proposal_gradient(monkeypatch)
    one_class_point_labels(monkeypatch)


def build(name):
    """The tiny two-stage model ``name`` on both sides from the reference's
    seeded init (BN statistics 0 and 1), and two training frames with
    planted gt boxes -> dict: the reference's model and variables, the
    port's model, the numpy batch, the port's config."""
    jcfg, pcfg = common.configs(name, keep_roi_head=True)
    ds, raw = _frames(pcfg, 2)
    raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    jds = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                               batch_size=1, training=False)[0]
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES), jds)
    variables = common._seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jax_load_data_to_device(dict(raw, batch_size=2))))
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return {"jmodel": jmodel, "vars": variables, "port": model,
            "raw": plant_gt(model, raw), "cfg": pcfg}


def roi_head_inputs(model, raw):
    """The batch dict a training forward of ``model`` (a copy: its BN
    statistics move) hands its ROI head on ``raw``."""
    seen = {}

    def grab(module, args):
        seen.update(args[0])
        raise StopIteration
    m = copy.deepcopy(model).train()
    hook = m.roi_head.register_forward_pre_hook(grab)
    try:
        m(load_data_to_device(raw, device="cpu"))
    except StopIteration:
        pass
    finally:
        hook.remove()
    return seen


def plant_gt(model, raw):
    inp = roi_head_inputs(model, raw)
    rois, labels = (inp[k].detach().numpy() for k in ("rois", "roi_labels"))
    gt = raw["gt_boxes"].copy()
    rng = np.random.RandomState(3)
    for b in range(gt.shape[0]):
        n = int((gt[b, :, 7] > 0).sum())
        assert n + PLANTED <= gt.shape[1]
        for j in range(PLANTED):
            box = rois[b, 4 * j].copy()
            box[0:2] += rng.uniform(-0.15, 0.15, 2)
            box[3:6] *= rng.uniform(1.0, 1.15, 3)
            gt[b, n + j, :7] = box
            gt[b, n + j, 7] = labels[b, 4 * j]
    return dict(raw, gt_boxes=gt)


def reference_step(r):
    """``jax.value_and_grad`` of the reference's training loss (jitted) on
    the batch -> (loss, tb_dict, gradients, BN statistics after it)."""
    params = r["vars"]["params"]
    other = {k: v for k, v in r["vars"].items() if k != "params"}

    def loss_fn(p, b):
        out, mut = r["jmodel"].apply({"params": p, **other}, b, train=True,
                                     mutable=["batch_stats"])
        return out["loss"], (mut, out["tb_dict"])
    (loss, (mut, tb)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jax_load_data_to_device(
            dict(r["raw"], batch_size=2)))
    return float(loss), {k: float(v) for k, v in tb.items()}, _np(grads), \
        _np(mut["batch_stats"])


def port_step(model, raw):
    """One ``train_step`` of a copy of ``model`` (sgd, no clip) -> (loss,
    tb_dict, the copy)."""
    m = copy.deepcopy(model)
    loss, tb = train_step(m, load_data_to_device(raw, device="cpu"),
                          build_optimizer(m.parameters(), EDict(SGD_NO_CLIP),
                                          1), grad_clip=0)
    return float(loss), {k: float(v) for k, v in tb.items()}, m


def self_spread(model, raw, eps=1e-6):
    """The port's own gradients with the inputs scaled by (1 +/- eps
    noise): every feature of the voxels' points (x, y, z, intensity; the
    voxels stay as they are) and the raw points' intensity (their
    coordinates, which pick the keypoints and their neighbours, stay as
    they are): per parameter, the larger distance of the two from the
    unperturbed step's -> {name: max |dg|}."""
    grads = []
    for sign in (0.0, 1.0, -1.0):
        rng = np.random.RandomState(1)
        moved = dict(raw, voxels=raw["voxels"] * (1 + sign * eps * rng
                                                  .standard_normal(
                                                      raw["voxels"].shape))
                     .astype(np.float32))
        if "points" in raw:
            x = raw["points"].copy()
            x[..., 3] *= 1 + sign * eps * rng.standard_normal(x.shape[:-1])
            moved["points"] = x
        _, _, m = port_step(model, moved)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    return {n: max(float((grads[k][n] - g).abs().max()) for k in (1, 2))
            for n, g in grads[0].items()}


def check_step(r, want, port, spread, max_spread_tensors):
    """The port's step against the reference's: loss and each tb term
    within LOSS_RTOL relative, BN statistics within STATS_TOL of max(1,
    scale), every gradient within GRAD_RTOL of its tensor's largest |g| or
    within twice the port's own spread, the latter for at most
    ``max_spread_tensors`` tensors -> the number that took the spread."""
    from q3d_tpu_torch.train_utils import biases_before_bn
    jloss, jtb, jgrads, jstats = want
    loss, tb, m = port
    assert set(tb) == set(jtb)
    for k, v in tb.items():
        assert abs(v - jtb[k]) <= LOSS_RTOL * max(abs(jtb[k]), 1e-6), \
            (k, v, jtb[k])
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    grads = state_dict_from_jax({"params": jgrads})
    params = dict(m.named_parameters())
    assert set(grads) == set(params)
    zero = biases_before_bn(m)
    top = max(float(g.abs().max()) for g in grads.values())
    flips = 0
    for name, g in grads.items():
        mine = params[name].grad
        err, scale = float((mine - g).abs().max()), float(g.abs().max())
        if name in zero:
            assert max(scale, float(mine.abs().max())) <= 1e-6 * top, name
            continue
        assert scale > 0 and err <= max(GRAD_RTOL * scale, 2 * spread[name]), \
            (name, err, scale, spread[name])
        flips += err > GRAD_RTOL * scale
    assert flips <= max_spread_tensors, flips
    stats = state_dict_from_jax({"batch_stats": jstats})
    buffers = dict(m.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name] - s).abs().max())
        assert err <= STATS_TOL * max(1.0, float(s.abs().max())), (name, err)
    return flips
