"""PyTorch port vs the JAX package: training the anchor heads (SECOND,
PointPillars).

* ``AxisAlignedTargetAssigner`` on the tiny PointPillars anchors and on
  planted anchor sets (an empty frame, zero-padded gt rows, a duplicated
  anchor that ties a gt's best IoU, NORM_BY_NUM_EXAMPLES, MATCH_HEIGHT):
  labels exactly equal, regression targets and weights within 1e-6 of
  their largest value.  The reference lays its targets out class by
  class, the port in the head's anchor order; the reference's are
  compared through that permutation (``head_order``), and the fault it
  corrects is pinned: every positive anchor of the port overlaps its gt,
  while the reference's layout puts positives on anchors that do not.
* each anchor loss term, ``add_sin_difference``, ``get_direction_target``
  and ``get_loss`` within 1e-6 relative;
* the PFN's ``BatchNorm1d`` in train mode, padded rows present: output and
  running statistics within 1e-6;
* one ``train_step`` of ``pointpillar_tiny.yaml`` and of the tiny SECOND
  (``second_iou_tiny.yaml`` as SECONDNet without its ROI head) on one
  frame, against the reference's ``make_train_step`` with its assigner's
  targets permuted into the head's order: loss within 1e-5, every
  gradient within 1e-4 of its tensor's largest, BN statistics within
  1e-5 (PR 8's float tolerances);
* QAT (port only, as the reference's ``test_qat_train_step_reduces_loss``):
  ``pointpillar_recipe`` and ``second_recipe`` through ``train_step``;
  every quantized weight and the PFN's ``Linear`` get finite nonzero
  gradients, and PointPillars' loss falls over 6 Adam steps.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.dense_heads.anchor_head_template import \
    AnchorHeadTemplate as JaxAnchorHeadTemplate
from q3d_tpu.models.dense_heads.target_assigner import \
    axis_aligned_target_assigner as jax_assigner_mod
from q3d_tpu.optimization import build_optimizer as jax_build_optimizer
from q3d_tpu.parallel import make_train_step
from q3d_tpu.utils import box_coder_utils as jax_coders
from q3d_tpu.utils import loss_utils as jax_loss

from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.dense_heads.anchor_head_template import \
    AnchorHeadTemplate
from q3d_tpu_torch.models.dense_heads.target_assigner.anchor_generator \
    import generate_anchors_from_cfg
from q3d_tpu_torch.models.dense_heads.target_assigner \
    .axis_aligned_target_assigner import AxisAlignedTargetAssigner
from q3d_tpu_torch.models.layers import BatchNorm1d
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils import box_coder_utils, box_utils, loss_utils
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_anchor_common as common
from test_torch_port_train_step import SGD, _np, _recording

torch.set_num_threads(2)


def head_order(anchors_list):
    """For each anchor in the head's order (the classes concatenated along
    the size axis), its index in the reference assigner's class-by-class
    layout."""
    sizes = [a[..., 0].size for a in anchors_list]
    offsets = np.cumsum([0] + sizes[:-1])
    idx = [(np.arange(s) + o).reshape(a.shape[:-1])
           for s, o, a in zip(sizes, offsets, anchors_list)]
    return np.concatenate(idx, axis=-2).reshape(-1)


def _frames(cfg, n, seed=0):
    """``n`` frames of the config's synthetic dataset, training pipeline
    (numpy batch)."""
    np.random.seed(seed)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=n, training=True)
    return ds, next(iter(loader))


def _planted(rng, gen_cfg, class_names):
    """Per-class anchor sets (1, 1, N, 1, 1, 7) scattered around gt boxes,
    and the gts (2, 12, 8): frame 0 empty, frame 1 with 9 boxes of every
    class and zero rows after them.  Car's anchor 5 is a copy of the Car
    anchor nearest the first gt's best, so that both tie its best IoU."""
    n = 40
    gt = np.zeros((2, 12, 8), np.float32)
    k = 9
    cls = np.array([1, 2, 3] * 3)
    sizes = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}
    gt[1, :k, 0] = rng.uniform(2, 36, k)
    gt[1, :k, 1] = rng.uniform(-17, 17, k)
    gt[1, :k, 2] = -1.0
    gt[1, :k, 3:6] = [np.array(sizes[c]) * rng.uniform(0.9, 1.1, 3)
                      for c in cls]
    gt[1, :k, 6] = rng.uniform(-np.pi, np.pi, k)
    gt[1, :k, 7] = cls
    anchors = []
    for ci, c in enumerate(gen_cfg):
        cid = class_names.index(c["class_name"]) + 1
        own = gt[1, :k][cls == cid]
        pick = own[rng.randint(len(own), size=n)]
        a = np.zeros((n, 7), np.float32)
        a[:, 0:2] = pick[:, 0:2] + rng.normal(0, 0.5, (n, 2))
        a[:, 2] = -1.0
        a[:, 3:6] = c["anchor_sizes"][0]
        a[:, 6] = rng.choice([0.0, 1.57], n)
        anchors.append(a)
    car = anchors[0]
    iou = box_utils.boxes3d_nearest_bev_iou(
        torch.from_numpy(car), torch.from_numpy(gt[1, :1, :7]))[:, 0]
    car[5] = car[int(iou.argmax())]
    return [a.reshape(1, 1, n, 1, 1, 7) for a in anchors], gt


def test_target_assigner_matches_reference():
    """Labels exactly equal (in the head's order), regression targets and
    weights within 1e-6 of their largest value; every positive anchor of
    the port overlaps (nearest-BEV IoU > 0) the gt it was assigned, of its
    own class.  ``planted``: an empty frame, zero rows, and two equal
    anchors tying the first gt's best IoU, both forced positive.  (The
    cases run in one test: a file with more tests is handed to an xdist
    worker before the tier-1 critical path.)"""
    for case in ("pointpillar_tiny", "planted", "planted_norm_by_examples",
                 "match_height"):
        _check_assigner(case)


def _check_assigner(case):
    jcfg, cfg = common.configs("pointpillar_tiny")
    head_cfg, jhead_cfg = cfg.MODEL.DENSE_HEAD, jcfg.MODEL.DENSE_HEAD
    names = list(cfg.CLASS_NAMES)
    rng = np.random.RandomState(7)
    if case.startswith("planted"):
        anchors_list, gt = _planted(rng, head_cfg.ANCHOR_GENERATOR_CONFIG,
                                    names)
    else:
        ds, raw = _frames(cfg, 2)
        anchors_list, _ = generate_anchors_from_cfg(
            head_cfg.ANCHOR_GENERATOR_CONFIG, np.asarray(ds.grid_size),
            ds.point_cloud_range)
        gt = raw["gt_boxes"]
        assert (gt[..., 7] > 0).sum(1).min() >= 3 and (gt[..., 7] == 0).any()
    norm = case == "planted_norm_by_examples"
    match_height = case == "match_height"
    for c in (head_cfg, jhead_cfg):
        c.TARGET_ASSIGNER_CONFIG.NORM_BY_NUM_EXAMPLES = norm

    jassign = jax_assigner_mod.AxisAlignedTargetAssigner(
        jhead_cfg, names, jax_coders.ResidualCoder(),
        match_height=match_height)
    ref = jax.jit(lambda g: jassign.assign_targets(anchors_list, g))(
        jnp.asarray(gt))
    perm = head_order(anchors_list)
    ref = {k: np.asarray(v)[:, perm] for k, v in ref.items()}

    assign = AxisAlignedTargetAssigner(head_cfg, names,
                                       box_coder_utils.ResidualCoder(),
                                       match_height=match_height)
    cat = np.concatenate(anchors_list, axis=-3)
    anchors = torch.from_numpy(np.ascontiguousarray(cat.reshape(-1, 7)))
    cls_id, m_th, u_th = (torch.from_numpy(t)
                          for t in assign.anchor_tables(anchors_list))
    mine = {k: v.numpy() for k, v in assign.assign_targets(
        anchors, cls_id, m_th, u_th, torch.from_numpy(gt)).items()}

    labels = mine["box_cls_labels"]
    np.testing.assert_array_equal(labels, ref["box_cls_labels"], err_msg=case)
    for key in ("box_reg_targets", "reg_weights", "matched_gt_boxes"):
        scale = max(float(np.abs(ref[key]).max()), 1e-30)
        assert np.abs(mine[key] - ref[key]).max() <= 1e-6 * scale, (case, key)
    assert (labels > 0).sum() > 5 and (labels == 0).sum() > 5
    flat = cat.reshape(-1, 7)
    if case.startswith("planted"):
        assert not (labels[0] != 0).any()           # the empty frame
        dup = anchors_list[0].reshape(-1, 7)[5]
        twins = np.flatnonzero((flat == dup).all(1))
        assert len(twins) >= 2 and (labels[1, twins] == 1).all()
    # each positive anchor is of its gt's class and overlaps it; the
    # reference's layout, read in the head's order, puts positives on
    # anchors of another class (more than one class)
    b, a = np.nonzero(labels > 0)
    assert (cls_id.numpy()[a] == labels[b, a]).all()
    if not match_height:
        iou = box_utils.boxes3d_nearest_bev_iou(
            torch.from_numpy(flat[a][:, None]),
            torch.from_numpy(mine["matched_gt_boxes"][b, a][:, None]))
        assert (iou > 0).all(), case
    raw_labels = np.asarray(jax.jit(lambda g: jassign.assign_targets(
        anchors_list, g))(jnp.asarray(gt))["box_cls_labels"])
    b, a = np.nonzero(raw_labels > 0)
    assert (cls_id.numpy()[a] != raw_labels[b, a]).any()


def _head_stand_in(jcfg, anchors_np, num_class):
    """The reference template's loss methods on a plain object (they read
    only ``model_cfg``, ``num_class`` and ``flat_anchors``)."""
    ns = types.SimpleNamespace(model_cfg=jcfg, num_class=num_class,
                               flat_anchors=lambda: jnp.asarray(anchors_np))
    ns.add_sin_difference = JaxAnchorHeadTemplate.add_sin_difference
    ns.get_direction_target = types.MethodType(
        JaxAnchorHeadTemplate.get_direction_target, ns)
    ns.get_loss = types.MethodType(JaxAnchorHeadTemplate.get_loss, ns)
    return ns


def test_anchor_losses_match_reference():
    """Each term on seeded inputs (targets from the assigner on real
    frames; NaN targets for the smooth-L1), within 1e-6 relative."""
    for term in ("focal", "smooth_l1", "cross_entropy", "sin_difference",
                 "direction_target", "get_loss"):
        _check_loss_term(term)


def _check_loss_term(term):
    jcfg, cfg = common.configs("pointpillar_tiny")
    ds, raw = _frames(cfg, 2)
    head = AnchorHeadTemplate(cfg.MODEL.DENSE_HEAD, 3, cfg.CLASS_NAMES,
                              ds.grid_size, ds.point_cloud_range)
    na = head.anchors.shape[0]
    targets = head.assign_targets(torch.from_numpy(raw["gt_boxes"]))
    tnp = {k: v.numpy() for k, v in targets.items()}
    ns = _head_stand_in(jcfg.MODEL.DENSE_HEAD, head.anchors.numpy(), 3)
    rng = np.random.RandomState(11)
    b = 2

    def close(mine, ref):
        mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
        assert mine.shape == ref.shape, term
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(mine - ref).max() <= 1e-6 * scale, (
            term, np.abs(mine - ref).max() / scale)

    if term == "focal":
        pred = rng.normal(0, 3, (b, na, 3)).astype(np.float32)
        onehot = np.eye(4, dtype=np.float32)[np.maximum(
            tnp["box_cls_labels"], 0)][..., 1:]
        w = rng.uniform(0, 1, (b, na)).astype(np.float32)
        close(loss_utils.sigmoid_focal_cls_loss(
            torch.tensor(pred), torch.tensor(onehot), torch.tensor(w)),
            jax_loss.sigmoid_focal_cls_loss(jnp.asarray(pred),
                                            jnp.asarray(onehot),
                                            jnp.asarray(w)))
    elif term == "smooth_l1":
        pred = rng.normal(0, 0.3, (b, na, 7)).astype(np.float32)
        tgt = tnp["box_reg_targets"].copy()
        tgt[0, :50, 2] = np.nan
        cw = [1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 3.0]
        close(loss_utils.WeightedSmoothL1Loss(code_weights=cw)(
            torch.tensor(pred), torch.tensor(tgt),
            torch.tensor(tnp["reg_weights"])),
            jax_loss.WeightedSmoothL1Loss(code_weights=cw)(
                jnp.asarray(pred), jnp.asarray(tgt),
                jnp.asarray(tnp["reg_weights"])))
        d = np.linspace(-0.3, 0.3, 101, dtype=np.float32)
        for beta in (1.0 / 9.0, 0.0):
            close(loss_utils.smooth_l1_loss(torch.tensor(d), beta),
                  jax_loss.smooth_l1_loss(jnp.asarray(d), beta))
    elif term == "cross_entropy":
        logits = rng.normal(0, 2, (b, na, 2)).astype(np.float32)
        onehot = np.eye(2, dtype=np.float32)[rng.randint(2, size=(b, na))]
        w = rng.uniform(0, 1, (b, na)).astype(np.float32)
        close(loss_utils.weighted_cross_entropy(
            torch.tensor(logits), torch.tensor(onehot), torch.tensor(w)),
            jax_loss.weighted_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(onehot),
                                            jnp.asarray(w)))
    elif term == "sin_difference":
        p = rng.normal(0, 1, (b, na, 7)).astype(np.float32)
        for mine, ref in zip(
                head.add_sin_difference(torch.tensor(p), targets[
                    "box_reg_targets"]),
                ns.add_sin_difference(jnp.asarray(p), jnp.asarray(
                    tnp["box_reg_targets"]))):
            close(mine, ref)
    elif term == "direction_target":
        rt = tnp["box_reg_targets"].copy()
        rt[..., 6] = rng.uniform(-7, 7, (b, na)).astype(np.float32)
        for one_hot in (True, False):
            close(head.get_direction_target(torch.tensor(rt), one_hot),
                  ns.get_direction_target(jnp.asarray(rt), one_hot))
    else:
        a = sum(head.num_anchors_per_location)
        h, w = ds.grid_size[1] // 2, ds.grid_size[0] // 2
        maps = {k: rng.normal(0, 1, (b, h, w, a * c)).astype(np.float32)
                for k, c in (("cls_preds", 3), ("box_preds", 7),
                             ("dir_cls_preds", 2))}
        loss, tb = head.get_loss({**{k: torch.tensor(v).permute(0, 3, 1, 2)
                                     for k, v in maps.items()}, **targets})
        rloss, rtb = ns.get_loss({**{k: jnp.asarray(v)
                                     for k, v in maps.items()},
                                  **{k: jnp.asarray(v)
                                     for k, v in tnp.items()}})
        assert set(tb) == set(rtb)
        for k in tb:
            close(tb[k].detach(), rtb[k])
        close(loss.detach(), rloss)


def test_pfn_batchnorm_train_mode_matches_reference():
    """The PFN's BatchNorm1d in train mode on (N, P, C) features whose
    padded point slots are zero rows (as PillarVFE feeds it): flax's
    BatchNorm over the (N * P, C) rows, as the reference's PFNLayer runs
    it; output within 1e-6 of its scale, running statistics within
    1e-6."""
    rng = np.random.RandomState(5)
    n, p, c = 60, 16, 32
    x = rng.normal(0.4, 1.7, (n, p, c)).astype(np.float32)
    npts = rng.randint(0, p + 1, n)
    x *= (np.arange(p)[None, :] < npts[:, None])[..., None]
    assert (x == 0).all(-1).sum() > n
    ra = {"mean": rng.normal(0, 1, c).astype(np.float32),
          "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    scale, bias = (rng.normal(1, 0.1, c).astype(np.float32),
                   rng.normal(0, 0.1, c).astype(np.float32))
    ref, mut = jax_layers.BatchNorm().apply(
        {"params": {"bn": {"scale": scale, "bias": bias}},
         "batch_stats": {"bn": ra}}, jnp.asarray(x.reshape(n * p, c)),
        train=True, mutable=["batch_stats"])
    bn = BatchNorm1d(c, eps=1e-3).train()
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(ra["mean"]),
                        "running_var": torch.tensor(ra["var"])})
    out = bn(torch.tensor(x)).detach().numpy().reshape(n * p, c)
    r = np.asarray(ref)
    assert np.abs(out - r).max() <= 1e-6 * np.abs(r).max()
    for k, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(
            mut["batch_stats"]["bn"][k]), rtol=0, atol=1e-6)


def _in_head_order(monkeypatch):
    """The reference assigner's targets permuted into the head's order."""
    real = jax_assigner_mod.AxisAlignedTargetAssigner.assign_targets

    def assign(self, all_anchors, gt):
        perm = jnp.asarray(head_order(all_anchors))
        return {k: v[:, perm] for k, v in real(self, all_anchors, gt).items()}
    monkeypatch.setattr(jax_assigner_mod.AxisAlignedTargetAssigner,
                        "assign_targets", assign)


def test_train_step_matches_reference(monkeypatch):
    """PointPillars and SECOND (tiny), each one sgd step (momentum 0.9,
    weight decay, both clips) from the reference's seeded init on one
    training frame (the same numpy batch on both sides): loss within 1e-5
    relative, every gradient after the step's own clip within 1e-4 of its
    tensor's largest |g|, the BN running statistics after the step within
    1e-5 of max(1, scale)."""
    _in_head_order(monkeypatch)
    for name in ("pointpillar_tiny", "second_iou_tiny"):
        _check_train_step(name)


def _check_train_step(name):
    ref = common.build_for_training(name)
    jmodel, variables, cfg = ref["model"], ref["vars"], ref["cfg"]
    _, raw = _frames(cfg, 1)
    raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    tx = _recording(jax_build_optimizer(JaxEDict(SGD), 3)[0])
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = tx.init(v["params"])
    step = make_train_step(jmodel, tx, grad_clip=10.0)
    v, state, jloss, jtb = step(v, state, jax_load_data_to_device(
        dict(raw, batch_size=1)))
    want_grads, want_stats = _np(state["g"]), _np(v["batch_stats"])

    model = ref["port"]
    opt = build_optimizer(model.parameters(), EDict(SGD), 3)
    loss, tb = train_step(model, load_data_to_device(raw, device="cpu"), opt,
                          grad_clip=10.0)
    assert set(tb) == set(jtb) == {"rpn_loss_cls", "rpn_loss_loc",
                                   "rpn_loss_dir", "rpn_loss"}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), name
    grads = state_dict_from_jax({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    zero = biases_before_bn(model)
    top = max(float(g.abs().max()) for g in grads.values())
    for pname, g in grads.items():
        mine = params[pname].grad
        err, scale = float((mine - g).abs().max()), float(g.abs().max())
        if pname in zero:
            assert max(scale, float(mine.abs().max())) <= 1e-6 * top, name
            continue
        assert scale > 0 and err <= 1e-4 * scale, (name, pname, err, scale)
    stats = state_dict_from_jax({"batch_stats": want_stats})
    buffers = dict(model.named_buffers())
    for sname, s in stats.items():
        err = float((buffers[sname] - s).abs().max())
        assert err <= 1e-5 * max(1.0, float(s.abs().max())), (name, sname,
                                                              err)


def test_qat_train_step():
    """Each model under its recipe (``pointpillar_recipe`` /
    ``second_recipe``, dynamic SmoothQuant fake-quant) through
    ``train_step``: every quantized conv's weight and the PFN's ``Linear``
    (left float by the recipe) get finite nonzero gradients, no quantizer
    state is a parameter; PointPillars' loss falls over 6 Adam steps on
    one batch (the reference's ``test_qat_train_step_reduces_loss``)."""
    for name in ("pointpillar_tiny", "second_iou_tiny"):
        _check_qat_step(name)


def _check_qat_step(name):
    _, cfg = common.configs(name)
    ds, raw = _frames(cfg, 2)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device="cpu")
    recipe = port_api.pointpillar_recipe() if name.startswith("point") \
        else port_api.second_recipe()
    port_api.quantize_model(model, recipe, batch)
    assert not [n for n, _ in model.named_parameters()
                if "quant" in n or "amax" in n]
    quantized = [m for m in model.modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None]
    assert len(quantized) == (6 if name.startswith("point") else 11 + 6), \
        name
    opt = build_optimizer(model.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), 6)
    losses = [float(train_step(model, batch, opt)[0])]
    watched = [m.weight for m in quantized]
    if name.startswith("point"):
        watched += [m.linear.weight for m in model.vfe.pfn_layers]
    for w in watched:
        assert torch.isfinite(w.grad).all() \
            and float(w.grad.abs().max()) > 0, name
    if name.startswith("point"):
        losses += [float(train_step(model, batch, opt)[0]) for _ in range(5)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
