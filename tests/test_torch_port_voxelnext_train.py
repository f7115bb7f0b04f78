"""PyTorch port vs the JAX package: training VoxelNeXt, tiny
(``voxelnext_tiny.yaml``), batch 2, f32.

* one training step from the reference's seeded init (BN statistics 0 and
  1) on two training frames, the same numpy batch on both sides, against
  ``jax.value_and_grad`` of the reference's loss (its probe table built per
  tensor, ``test_torch_port_voxelnext.fresh_probes``): the loss within
  1e-5 relative, every gradient within 1e-4 of its tensor's largest |g|,
  the BN running statistics within 1e-5 (``test_torch_port_train_step.
  py``'s float tolerances); shared_conv's bias feeds a train-mode BN, so
  its gradient is rounding noise on both sides (``biases_before_bn``).  Every sparse conv, the 2D ones included,
  runs its input gradient over the inverse book;
* ``assign_targets_one_head`` for each head and frame on the step's own
  encoded rows: heatmap and regression targets within 1e-6 of their
  largest value, ``inds`` and ``mask`` equal; and a built case where two
  rows tie for an object's nearest voxel (the lowest row wins, as
  ``jnp.argmin``);
* ``FocalLossSparse`` and ``RegLossSparse`` within 1e-6 relative, a heatmap
  without positives included;
* the reference's velocity-target fault, pinned and not copied
  (``ROADMAP.md`` §3): with a ``vel`` branch and gt boxes of 8 columns its
  regression target has 8 columns for 10 predictions and the loss cannot
  be built; the port pads the velocity target with 0 and trains;
* QAT: a SubMConv2d under ``voxelnext_recipe()``'s sparse 2D rule (the
  gather-view SmoothQuant) fed the reference's input and output gradient,
  output and straight-through gradients within 1e-5 of each tensor's
  largest value (the reference's SmoothQuant column scale patched in, as
  in ``test_torch_port_train_step.py``); the tiny model under the recipe
  through ``train_step``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.dense_heads import voxelnext_head as jvh
from q3d_tpu.ops.spconv import SparseConvTensor as JaxSparseConvTensor
from q3d_tpu.ops.spconv import modules as jmodules
from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant.rules import QuantRules as JaxQuantRules
from q3d_tpu.quant.rules import quant_rules_scope
from q3d_tpu.utils import loss_utils as jax_loss

from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models import load_data_to_device
from q3d_tpu_torch.models.dense_heads.voxelnext_head import VoxelNeXtHead
from q3d_tpu_torch.ops.spconv import SparseConvTensor, SubMConv2d
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant import tensor_quant as port_tensor_quant
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils import loss_utils
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_anchor_common as common
from test_torch_port_anchor_train import _frames
from test_torch_port_train_step import SGD, _np, _reference_sq_scale
from test_torch_port_voxelnext import fresh_probes
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LOSS_RTOL, GRAD_RTOL, STATS_TOL, TARGET_TOL = 1e-5, 1e-4, 1e-5, 1e-6
# the step's gradients are read after it: no clip in the optimizer either
SGD_NO_CLIP = {**SGD, "GRAD_NORM_CLIP": 0}


def reference_step(ref, raw):
    """``jax.value_and_grad`` of the reference's training loss (jitted) ->
    (loss, tb_dict, gradients, batch statistics after the forward)."""
    jbatch = jax_load_data_to_device(dict(raw, batch_size=2))
    params = ref["vars"]["params"]
    other = {k: v for k, v in ref["vars"].items() if k != "params"}

    def loss_fn(p, b):
        out, mut = ref["model"].apply({"params": p, **other}, b, train=True,
                                      mutable=["batch_stats"])
        return out["loss"], (mut, out["tb_dict"])
    with fresh_probes():
        (loss, (mut, tb)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jbatch)
    return float(loss), {k: float(v) for k, v in tb.items()}, _np(grads), \
        _np(mut["batch_stats"])


@pytest.fixture(scope="module")
def vt():
    """The reference's and the port's tiny VoxelNeXt from one seeded init,
    a training batch of two frames, the reference's step on it and the
    port's encoded rows of that batch."""
    ref = common.build_for_training("voxelnext_tiny")
    _, raw = _frames(ref["cfg"], 2)
    raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    loss, tb, grads, stats = reference_step(ref, raw)
    model = ref["port"]
    batch = load_data_to_device(raw, device="cpu")
    with torch.no_grad():
        st = model.backbone_3d(model.vfe(dict(batch)))["encoded_spconv_tensor"]
    return {"ref": ref, "raw": raw, "batch": batch, "loss": loss, "tb": tb,
            "grads": grads, "stats": stats, "st": st,
            "init": copy.deepcopy(model)}


def test_train_step_matches_reference(vt):
    """One ``train_step`` (sgd, neither clip) against the reference's loss and
    ``jax.grad`` on the same batch: loss and tb_dict within 1e-5 relative,
    every gradient within 1e-4 of its tensor's largest |g| (shared_conv's
    bias, before a train-mode BN: both below 1e-6 of the model's largest),
    the BN running statistics within 1e-5 of max(1, scale)."""
    model = vt["ref"]["port"]
    opt = build_optimizer(model.parameters(), EDict(SGD_NO_CLIP), 1)
    loss, tb = train_step(model, vt["batch"], opt, grad_clip=0)
    assert set(tb) == set(vt["tb"]) == {
        f"{k}_loss_head_{i}" for k in ("hm", "loc") for i in (0, 1)}
    for k, v in tb.items():
        assert abs(float(v) - vt["tb"][k]) <= LOSS_RTOL * abs(vt["tb"][k]), k
    assert abs(float(loss) - vt["loss"]) <= LOSS_RTOL * abs(vt["loss"])

    grads = state_dict_from_jax({"params": vt["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    zero = biases_before_bn(model)
    assert zero == {"backbone_3d.shared_conv.0.bias"}
    top = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        mine = params[name].grad
        err, scale = float((mine - g).abs().max()), float(g.abs().max())
        if name in zero:
            assert max(scale, float(mine.abs().max())) <= 1e-6 * top, name
            continue
        assert scale > 0 and err <= GRAD_RTOL * scale, (name, err, scale)
    stats = state_dict_from_jax({"batch_stats": vt["stats"]})
    buffers = dict(model.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name] - s).abs().max())
        assert err <= STATS_TOL * max(1.0, float(s.abs().max())), (name, err)


def _heads(ref, head_dict=None):
    """The reference's and the port's VoxelNeXtHead of the tiny config
    (``head_dict`` replacing its branches) -> (jax head, port head)."""
    jcfg, pcfg = common.configs("voxelnext_tiny")
    heads = []
    for cfg, cls in ((jcfg, jvh.VoxelNeXtHead), (pcfg, VoxelNeXtHead)):
        hcfg = cfg.MODEL.DENSE_HEAD
        if head_dict is not None:
            hcfg.SEPARATE_HEAD_CFG.HEAD_DICT = head_dict
            hcfg.SEPARATE_HEAD_CFG.HEAD_ORDER = list(head_dict)
        geo = {k: tuple(getattr(ref["port"].dataset, k)) for k in (
            "grid_size", "point_cloud_range", "voxel_size")}
        heads.append(cls(model_cfg=hcfg, input_channels=64, num_class=3,
                         class_names=tuple(cfg.CLASS_NAMES), **geo))
    generator = torch.Generator().manual_seed(0)
    for m in heads[1].modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return heads


def _assign_both(jhead, head, gt, ids, xy, vb, valid, b):
    want = jhead.apply({}, jnp.asarray(gt), ids, len(ids), jnp.asarray(xy),
                       jnp.asarray(vb), jnp.asarray(valid), b,
                       method=jvh.VoxelNeXtHead.assign_targets_one_head)
    got = head.assign_targets_one_head(
        torch.from_numpy(gt), ids, len(ids), torch.from_numpy(xy),
        torch.from_numpy(vb), torch.from_numpy(valid), b)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_assign_targets_match_reference(vt):
    """Every head and frame on the step's encoded rows, then a built case:
    one object whose two nearest rows (frame 0) lie on one cell, a nearer
    row of frame 1 and pad rows; heatmap and boxes within 1e-6 of their
    largest value, inds and mask equal."""
    jhead, head = _heads(vt["ref"])
    st = vt["st"]
    xy = torch.stack([st.indices[:, 2], st.indices[:, 1]], 1).numpy()
    vb, valid = st.indices[:, 0].numpy(), st.valid.numpy()
    gt = vt["raw"]["gt_boxes"].astype(np.float32)
    n_masked = 0
    for h, ids in enumerate(head.class_id_mapping_each_head):
        for b in range(2):
            want, got = _assign_both(jhead, head, gt[b], ids, xy, vb, valid,
                                     b)
            _check_targets(want, got, (h, b))
            n_masked += int(got[3].sum())
    assert n_masked >= 10

    box = np.zeros((3, 8), np.float32)
    box[0] = [10.0, 1.0, -1.0, 4.0, 1.8, 1.6, 0.3, 1]      # Car (head 0)
    cell = ((np.array([10.0, 1.0]) - head.point_cloud_range[:2])
            / head.voxel_size[:2] / head.feature_map_stride).astype(np.int32)
    xy = np.array([[0, 0], cell + 1, cell + [3, 0], cell + 1, cell,
                   [-1, -1], [-1, -1]], np.int32)
    vb = np.array([0, 0, 0, 0, 1, -1, -1], np.int32)
    want, got = _assign_both(jhead, head, box,
                             head.class_id_mapping_each_head[0], xy, vb,
                             vb >= 0, 0)
    _check_targets(want, got, "tie")
    assert got[2][0] == 1 and got[3].tolist() == [True, False, False]


def _check_targets(want, got, case):
    for what, w, g in zip(("heatmap", "boxes"), want[:2], got[:2]):
        assert w.shape == g.shape, (case, what)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= TARGET_TOL * scale, (case, what)
    np.testing.assert_array_equal(got[2], want[2], err_msg=str(case))
    np.testing.assert_array_equal(got[3], want[3], err_msg=str(case))


def test_sparse_losses_and_velocity_fault(vt):
    """``FocalLossSparse`` (with and without positive rows, with and
    without the row mask) and ``RegLossSparse`` within 1e-6 relative.
    Then the velocity-target fault: the reference's targets for a head with
    a ``vel`` branch on 8-column gt boxes have 8 columns, so its loss of the
    10 predicted ones raises; the port's have 10, the last two 0, and its
    head's loss is finite."""
    rng = np.random.RandomState(5)
    n, c = 400, 2
    pred = rng.uniform(0, 1, (n, c)).astype(np.float32)
    gt = np.where(rng.uniform(size=(n, c)) < 0.3,
                  rng.uniform(0, 1, (n, c)), 0).astype(np.float32)
    gt[[3, 50, 77], [0, 1, 0]] = 1.0
    valid = rng.uniform(size=n) < 0.8
    for g in (gt, np.minimum(gt, 0.9)):                  # positives, none
        for v in (valid, None):
            want = float(jax_loss.FocalLossSparse()(
                jnp.asarray(pred), jnp.asarray(g),
                None if v is None else jnp.asarray(v)))
            got = float(loss_utils.FocalLossSparse()(
                torch.from_numpy(pred), torch.from_numpy(g),
                None if v is None else torch.from_numpy(v)))
            assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    preds = rng.normal(0, 1, (n, 8)).astype(np.float32)
    inds = rng.randint(0, n, (2, 16))
    mask = rng.uniform(size=(2, 16)) < 0.7
    target = rng.normal(0, 1, (2, 16, 8)).astype(np.float32)
    want = float(jax_loss.RegLossSparse()(*map(jnp.asarray, (
        preds, mask, inds, target))))
    got = float(loss_utils.RegLossSparse()(*map(torch.from_numpy, (
        preds, mask, inds, target))))
    assert abs(got - want) <= 1e-6 * abs(want)

    head_dict = {"center": {"out_channels": 2, "num_conv": 2},
                 "center_z": {"out_channels": 1, "num_conv": 2},
                 "dim": {"out_channels": 3, "num_conv": 2},
                 "rot": {"out_channels": 2, "num_conv": 2},
                 "vel": {"out_channels": 2, "num_conv": 2}}
    jhead, head = _heads(vt["ref"], head_dict)
    st = vt["st"]
    xy = torch.stack([st.indices[:, 2], st.indices[:, 1]], 1).numpy()
    gt_boxes = vt["raw"]["gt_boxes"].astype(np.float32)
    ids = head.class_id_mapping_each_head[0]
    want, got = _assign_both(jhead, head, gt_boxes[0], ids, xy,
                             st.indices[:, 0].numpy(), st.valid.numpy(), 0)
    assert want[1].shape[1] == 8 and got[1].shape[1] == 10
    assert got[3].any() and not got[1][:, 8:].any()
    np.testing.assert_allclose(got[1][:, :8], want[1], rtol=0,
                               atol=TARGET_TOL * np.abs(want[1]).max())
    preds10 = jnp.zeros((st.capacity, 10), jnp.float32)
    with pytest.raises((TypeError, ValueError)):
        jax_loss.RegLossSparse()(preds10, jnp.asarray(want[3])[None],
                                 jnp.asarray(want[2])[None],
                                 jnp.asarray(want[1])[None])
    head.train()
    out = head({"encoded_spconv_tensor": st,
                "gt_boxes": torch.from_numpy(gt_boxes)})
    assert torch.isfinite(out["loss"]) and len(out["tb_dict"]) == 4


def _sparse_2d(rng, n=300, cap=384, c=32, hw=(20, 24)):
    """A batch-2 2D sparse tensor (sorted rows, pad rows last) of post-ReLU
    features, as numpy arrays."""
    cells = np.sort(rng.choice(2 * hw[0] * hw[1], n, replace=False))
    b, rem = np.divmod(cells, hw[0] * hw[1])
    idx = np.full((cap, 3), -1, np.int32)
    idx[:n] = np.stack([b, rem // hw[1], rem % hw[1]], 1)
    feats = np.zeros((cap, c), np.float32)
    feats[:n] = np.maximum(rng.randn(n, c), 0) * 2.0
    return feats, idx, hw


def test_qat_gather_view_smoothquant_and_train_step(monkeypatch, vt):
    """A SubMConv2d (32 -> 32, 3x3) under ``voxelnext_recipe()``'s sparse
    2D rule (dynamic SmoothQuant over the gather view), fed the reference's
    input and output gradient: output, dX and dW within 1e-5 of each
    tensor's largest value, the float layer more than 1e-3 away.  Then the
    tiny model under the recipe through ``train_step``: every quantized
    conv's weight gets a finite nonzero gradient, no quantizer state is a
    parameter."""
    monkeypatch.setattr(port_tensor_quant, "smoothquant_scale",
                        _reference_sq_scale)
    rng = np.random.RandomState(23)
    feats, idx, hw = _sparse_2d(rng)
    jrule = jax_api.voxelnext_recipe().rules[1]
    rule = port_api.voxelnext_recipe().rules[1]
    jst = JaxSparseConvTensor(features=jnp.asarray(feats),
                              indices=jnp.asarray(idx), spatial_shape=hw,
                              batch_size=2, sorted_rows=True)
    jmod = jmodules.SubMConv2d(32, 3, 1, 1, use_bias=False)
    with quant_rules_scope(JaxQuantRules(rules=(jrule,))):
        v = jmod.init(jax.random.PRNGKey(3), jst, {})
    w = v["params"]["weight"]

    def ref_fn(x, wt):
        with quant_rules_scope(JaxQuantRules(rules=(jrule,))):
            return jmod.apply({**v, "params": {"weight": wt}},
                              jst.replace(features=x), {}).features
    out, vjp = jax.vjp(jax.jit(ref_fn), jnp.asarray(feats), w)
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]

    mod = SubMConv2d(32, 32, 3, 1, 1)
    mod.weight.data = torch.from_numpy(np.array(w))

    def port(quantized):
        xt = torch.tensor(feats, requires_grad=True)
        st = SparseConvTensor(features=xt, indices=torch.from_numpy(idx),
                              spatial_shape=hw, batch_size=2,
                              sorted_rows=True)
        mod.rule, mod.weight.grad = None, None
        if quantized:
            mod.rule, mod.calibrating = rule, True
            with torch.no_grad():
                mod(st.replace(features=xt.detach()), {})
            mod.calibrating = False
        y = mod(st, {}).features
        (y * torch.from_numpy(cot)).sum().backward()
        return [y.detach().numpy(), xt.grad.numpy(), mod.weight.grad.numpy()]

    float_got, got = port(False), port(True)
    for name, g, r, f in zip(("out", "dX", "dW"), got, want, float_got):
        scale = np.abs(r).max()
        assert g.shape == r.shape and scale > 0, name
        assert np.abs(g - r).max() <= 1e-5 * scale, (name, np.abs(g - r)
                                                     .max() / scale)
        assert np.abs(f - r).max() > 1e-3 * scale, name

    monkeypatch.undo()        # the model's step runs the port's own scale
    model = vt["init"]
    port_api.quantize_model(model, port_api.voxelnext_recipe(), vt["batch"])
    assert not [n for n, _ in model.named_parameters()
                if "quant" in n or "amax" in n]
    quantized = [m for m in model.modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None]
    assert sum(isinstance(m, SubMConv2d) for m in quantized) >= 2
    opt = build_optimizer(model.parameters(), EDict(SGD), 1)
    loss, _ = train_step(model, vt["batch"], opt)
    assert torch.isfinite(loss)
    for m in quantized:
        assert torch.isfinite(m.weight.grad).all() \
            and float(m.weight.grad.abs().max()) > 0
