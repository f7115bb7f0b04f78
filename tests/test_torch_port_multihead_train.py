"""PyTorch port vs the JAX package: training SECOND-MultiHead, on the small
model that ``torch_port_multihead_common`` makes from the Lyft yaml.

* one ``train_step`` from the reference's seeded init on one training
  frame (the same numpy batch on both sides; the yaml's 500 gt slots, of
  which the port's assigner reads up to the last gt), against the
  reference's ``make_train_step`` with its fill patched to the port's
  (``patched_fill``) and its assigner's targets permuted into the head's
  order (``test_torch_port_anchor_train._in_head_order``): loss within
  1e-5 relative, every gradient after the step's own clip within 1e-4 of
  its tensor's largest |g| (the towers whose classes no gt holds, 2-4:
  conv_box's exactly 0 on both sides), the BN running statistics within
  1e-5 of max(1, scale) (``test_torch_port_train_step.py``'s float
  tolerances); the absent class channels add exactly 0 to the focal loss.
  Where the port's own step
  moves a gradient by more than that when the input's points are scaled
  by 1 +/- 1e-7 noise, it is held within twice that move, and at most 30
  tensors may be: on this frame an activation of the early sparse
  backbone sits within that noise of a ReLU's or a BN's threshold, and
  the port then moves ``conv2.1.conv2``'s weight gradient by 2.85e-3 of
  its scale against itself, by 2.85e-3 against the reference (measured;
  every head and BEV gradient within 2e-5 of its scale);
* QAT under ``second_recipe()`` (port only, as the reference's
  ``test_qat_train_step_reduces_loss``): the recipe keeps no tower's output
  conv float (its no_list names AnchorHeadSingle's convs), every quantized
  weight gets a finite, nonzero gradient (but the idle towers' conv_box,
  exactly 0), and the loss falls over 3 Adam steps on one batch;
* every full-width yaml of ``tools/cfgs/{kitti,nuscenes,waymo,once,
  lyft}_models`` builds, and the Lyft one takes the reference's
  full-width variable tree strictly.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models.detectors.detector3d_template import (
    DatasetInfo as JaxDatasetInfo)
from q3d_tpu.optimization import build_optimizer as jax_build_optimizer
from q3d_tpu.parallel import make_train_step

import torch_port_multihead_common as common
from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.datasets.lyft_synthetic import LYFT_CFG
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.detectors.detector3d_template import DatasetInfo
from q3d_tpu_torch.models.dense_heads.anchor_head_multi import ABSENT_LOGIT
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils import loss_utils
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_anchor_train import _in_head_order
from test_torch_port_train_step import SGD, _np, _recording
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


def _self_spread(model, raw, eps=1e-7):
    """The port's own gradients under the input's points scaled by (1 +/-
    eps noise): per parameter, the larger distance of the two from the
    unperturbed step's, in the step's own clip -> {name: max |dg|}."""
    grads = []
    for sign in (0.0, 1.0, -1.0):
        m = copy.deepcopy(model)
        noise = np.random.RandomState(1).standard_normal(raw["voxels"].shape)
        r = dict(raw, voxels=(raw["voxels"] * (1 + sign * eps * noise))
                 .astype(np.float32))
        train_step(m, load_data_to_device(r, device="cpu"),
                   build_optimizer(m.parameters(), EDict(SGD), 3),
                   grad_clip=10.0)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    return {n: max(float((grads[k][n] - g).abs().max()) for k in (1, 2))
            for n, g in grads[0].items()}


def test_train_step_matches_reference(monkeypatch):
    _in_head_order(monkeypatch)
    ref = common.build(batch_size=1, training=True)
    raw = {k: v for k, v in ref["raw"].items() if k in MODEL_KEYS}
    assert raw["gt_boxes"].shape[1] == 500
    assert 0 < (raw["gt_boxes"][..., 7] > 0).sum() < 50
    tx = _recording(jax_build_optimizer(JaxEDict(SGD), 3)[0])
    v = jax.tree_util.tree_map(jnp.asarray, ref["vars"])
    state = tx.init(v["params"])
    step = make_train_step(ref["model"], tx, grad_clip=10.0)
    with common.patched_fill():
        v, state, jloss, jtb = step(v, state, common.jax_batch(
            dict(raw, batch_size=1)))
    want_grads, want_stats = _np(state["g"]), _np(v["batch_stats"])

    model = ref["port"]
    spread = _self_spread(model, raw)
    opt = build_optimizer(model.parameters(), EDict(SGD), 3)
    batch = load_data_to_device(raw, device="cpu")
    loss, tb = train_step(model, batch, opt, grad_clip=10.0)
    assert set(tb) == set(jtb) == {"rpn_loss_cls", "rpn_loss_loc",
                                   "rpn_loss"}
    for k in tb:
        assert abs(float(tb[k]) - float(jtb[k])) <= 1e-5 * abs(
            float(jtb[k])), k
    grads = state_dict_from_jax({"params": want_grads})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    zero = biases_before_bn(model)
    idle = common.idle_box_convs(model, raw["gt_boxes"])
    assert len(idle) == 3                      # heads 2-4 see no object
    top = max(float(g.abs().max()) for g in grads.values())
    flips = 0
    for pname, g in grads.items():
        mine = params[pname].grad
        err, scale = float((mine - g).abs().max()), float(g.abs().max())
        if pname in zero:
            assert max(scale, float(mine.abs().max())) <= 1e-6 * top, pname
            continue
        if pname.rsplit(".", 1)[0] in idle:
            assert scale == 0 and float(mine.abs().max()) == 0, pname
            continue
        assert scale > 0 and err <= max(1e-4 * scale, 2 * spread[pname]), (
            pname, err, scale, spread[pname])
        flips += spread[pname] > 1e-4 * scale
    assert flips <= 30, flips
    stats = state_dict_from_jax({"batch_stats": want_stats})
    buffers = dict(model.named_buffers())
    for sname, s in stats.items():
        err = float((buffers[sname] - s).abs().max())
        assert err <= 1e-5 * max(1.0, float(s.abs().max())), (sname, err)

    # the absent channels' share of the classification loss: exactly 0
    head = model.dense_head
    with torch.no_grad():
        bd = model(dict(batch))
        targets = head.assign_targets(batch["gt_boxes"])
    cls = head._flat(bd["cls_preds"], 1, head.anchors.shape[0])
    absent = cls == ABSENT_LOGIT
    assert absent.float().mean() == 8 / 9
    onehot = torch.nn.functional.one_hot(
        targets["box_cls_labels"].clamp(min=0), 10)[..., 1:].float()
    terms = loss_utils.sigmoid_focal_cls_loss(cls, onehot, torch.ones(
        cls.shape[:2]))
    assert (terms[absent] == 0).all() and (terms[~absent] > 0).all()


def test_qat_train_step():
    _, cfg = common.configs()
    geo, raw = common.data(cfg, batch_size=2, training=True)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), DatasetInfo(**geo),
                          device="cpu")
    batch = load_data_to_device({k: v for k, v in raw.items()
                                 if k in MODEL_KEYS}, device="cpu")
    port_api.quantize_model(model, port_api.second_recipe(), batch)
    quantized = {n: m for n, m in model.named_modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None}
    # 20 sparse convs (conv_input float), 4 BEV convs, the shared conv and
    # each tower's conv0, conv_cls and conv_box
    assert len(quantized) == 20 + 4 + 1 + 3 * 5, sorted(quantized)
    assert "dense_head.heads.0.conv_cls" in quantized
    opt = build_optimizer(model.parameters(), EDict(
        {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.0}), 3)
    losses = [float(train_step(model, batch, opt)[0])]
    idle = common.idle_box_convs(model, raw["gt_boxes"])
    for name, m in quantized.items():
        g = m.weight.grad
        assert torch.isfinite(g).all() and (float(g.abs().max()) > 0) \
            == (name not in idle), name
    losses += [float(train_step(model, batch, opt)[0]) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _info(path):
    """A yaml's geometry as a DatasetInfo (no dataset is needed to build
    the model)."""
    cfg = cfg_from_yaml_file(str(path), EDict())
    dc = cfg.DATA_CONFIG
    vox = [p for p in dc.DATA_PROCESSOR
           if p.NAME == "transform_points_to_voxels"][0]
    pc = np.asarray(dc.POINT_CLOUD_RANGE, np.float32)
    grid = np.round((pc[3:] - pc[:3]) / np.asarray(vox.VOXEL_SIZE,
                                                     np.float32)).astype(int)
    return cfg, vox, dict(
        class_names=tuple(cfg.CLASS_NAMES),
        num_point_features=len(dc.POINT_FEATURE_ENCODING.used_feature_list),
        grid_size=tuple(int(g) for g in grid),
        point_cloud_range=tuple(float(v) for v in pc),
        voxel_size=tuple(float(v) for v in vox.VOXEL_SIZE))


def test_full_width_yamls_build():
    """Every full-width yaml of ``tools/cfgs/{kitti,nuscenes,waymo,once,
    lyft}_models`` builds in the port on the CPU, MODEL as written.  The
    Lyft one at its geometry: 720,000 anchors a frame (200 x 200 cells x 9
    classes x 2 rotations), the sin/cos coder's 8 box codes, five towers;
    and the reference's full-width variable tree (``jax.eval_shape`` at
    60,000 voxels, its coder copied to where it reads it) goes through
    ``state_dict_from_jax`` and loads strictly, every shape equal."""
    paths = sorted(p for d in ("kitti", "nuscenes", "waymo", "once", "lyft")
                   for p in (LYFT_CFG.parents[1] / f"{d}_models").glob(
                       "*.yaml") if p != LYFT_CFG) + [LYFT_CFG]
    assert len(paths) == 10
    for path in paths:
        cfg, vox, geo = _info(path)
        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                              DatasetInfo(**geo), device="cpu")
        assert sum(p.numel() for p in model.parameters()) > 4e6, path
    assert path == LYFT_CFG
    head = model.dense_head
    assert head.anchors.shape == (720000, 8) and geo["grid_size"] == (
        1600, 1600, 40)
    assert head.box_coder.code_size == 8 and len(head.heads) == 5
    assert [t.conv_box.weight.shape[0] for t in head.heads] \
        == [16, 32, 32, 32, 32]
    jcfg = common.coder_at_head_level(jax_cfg_from_yaml(str(path),
                                                        JaxEDict()))
    v, p = int(vox.MAX_NUMBER_OF_VOXELS["test"]), int(vox.MAX_POINTS_PER_VOXEL)
    batch = {"voxels": jax.ShapeDtypeStruct((2, v, p, 5), np.float32),
             "voxel_coords": jax.ShapeDtypeStruct((2, v, 3), np.int32),
             "voxel_num_points": jax.ShapeDtypeStruct((2, v), np.int32),
             "batch_size": 2}
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES),
                               JaxDatasetInfo(**geo))
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, train=False),
                            jax.random.PRNGKey(0), batch)
    state = state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), flax.core.unfreeze(shapes)))
    own = model.state_dict()
    assert set(state) == set(own)
    for key, t in state.items():
        assert tuple(t.shape) == tuple(own[key].shape), key
    model.load_state_dict(state, strict=True)
