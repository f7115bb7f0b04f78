"""PyTorch port vs the JAX package: training PartA2, tiny
(``parta2_tiny.yaml``), batch 2, f32 (``torch_port_two_stage_train_common``
builds both sides and says how the reference is patched in the test; its
AVG pool is also patched to each frame's own rows,
``test_torch_port_parta2.own_frame_avg_pool``).

* ``PointIntraPartOffsetHead``'s train branch fed the port's training
  inputs (the UNet's point features and coordinates, gt boxes with planted
  rows): the point targets and box indices equal, the part targets within
  1e-6, ``point_cls_loss`` and ``point_part_loss``, their gradients (the
  head's parameters, the point features) and the BN statistics within
  1e-5; and with a ``PointResidualCoder`` box branch, ``point_box_loss``
  and its gradients too;
* ``PartA2FCHead``'s train branch on the same inputs: both losses and the
  gradients of its parameters and of the point, part-offset and score
  features it pools within 1e-5 of their scale (the point features' where
  they are not 0: a cell's max tied at 0 splits its gradient among the
  tied rows, the reference's among the other frames' zeroed rows too, and
  the ReLU that made them 0 passes none of it on);
* one training step from the reference's seeded init against
  ``jax.value_and_grad`` of the patched reference, held by
  ``check_step`` (the same pre-ReLU sign flip as in PV-RCNN's step: the
  gradients that move under 1 +/- 1e-6 noise on the voxels take the
  port's own spread, at most ``MAX_SPREAD_TENSORS`` of them, 37 measured
  on 2 threads, the deblock below among them); the spread also takes in the port's own move between
  its step on 2 threads and on 1 or 4 (``thread_spread``): on 2 threads
  the first deblock's weight gradient, a sum with heavy cancellation
  (rpn_loss_cls ~52 on the seeded init), lies 1.42e-4 of its scale from
  its 1- and 4-thread values, as far as from the reference's (1.41e-4,
  measured);
* the port's train CLI on both new tiny yamls (PartA2, SECOND-IoU) on the
  CPU: one epoch of two frames at batch 2, finite losses, the checkpoint
  written.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models.dense_heads import point_head as jax_point_head
from q3d_tpu.models.roi_heads import PartA2FCHead as JaxPartA2FCHead

import torch_port_anchor_common as common
import torch_port_two_stage_train_common as ts
from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models.dense_heads.point_head_simple import (
    assign_point_boxes)
from q3d_tpu_torch.models.dense_heads.point_intra_part_head import (
    PointIntraPartOffsetHead)
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_centerpoint import CFG_DIR, ROOT
from test_torch_port_parta2 import own_frame_avg_pool
from test_torch_port_train_step import _np
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
NAME = "parta2_tiny"
RTOL = 1e-5
# of the gradients (the biases before a BN apart), those that may take the
# port's own spread as their tolerance (37 measured: the 3D backbone's
# first convs and BNs and UNetV2's decoder)
MAX_SPREAD_TENSORS = 44
MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


@pytest.fixture(scope="module")
def two_stage():
    with pytest.MonkeyPatch.context() as mp:
        ts.patch_reference(mp)
        own_frame_avg_pool(mp)
        r = ts.build(NAME)
        r["want"] = ts.reference_step(r)
    r["inp"] = ts.roi_head_inputs(r["port"], r["raw"])
    return r


def _close(mine, want, what):
    want = np.asarray(want)
    mine = np.zeros_like(want) if mine is None else mine.detach().numpy()
    scale = float(np.abs(want).max())
    assert scale > 0, what
    assert float(np.abs(mine - want).max()) <= RTOL * scale, what


def _check_params(head, jgrads, module):
    grads = state_dict_from_jax({"params": {module: _np(jgrads)}})
    params = dict(head.named_parameters())
    assert set(grads) == {f"{module}.{n}" for n in params}
    for name, g in grads.items():
        _close(params[name.split(".", 1)[1]].grad, g, name)


def _point_head_case(r, cfg, jcfg, v):
    """One train forward and backward of the point head on the fixture's
    inputs on both sides -> (the port's head, its outputs, the reference's
    loss terms, parameter and feature gradients, BN statistics)."""
    inp = r["inp"]
    ds = r["port"].dataset
    feats = inp["point_features"].detach().numpy()
    fixed = {"point_coords": jnp.asarray(inp["point_coords"].numpy()),
             "gt_boxes": jnp.asarray(inp["gt_boxes"].numpy())}
    jhead = jax_point_head.PointIntraPartOffsetHead(
        model_cfg=jcfg, num_class=1, input_channels=16,
        voxel_size=tuple(ds.voxel_size),
        point_cloud_range=tuple(ds.point_cloud_range))
    if v is None:
        v = common._seeded_variables(jax.eval_shape(
            lambda k, f: jhead.init(k, dict(fixed, point_features=f)),
            jax.random.PRNGKey(0), jnp.asarray(feats)), seed=4)

    def loss_fn(p, f):
        out, mut = jhead.apply({"params": p, "batch_stats":
                                v["batch_stats"]},
                               dict(fixed, point_features=f), train=True,
                               mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mut)
    (_, (tb, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(v["params"],
                                                 jnp.asarray(feats))
    head = PointIntraPartOffsetHead(cfg, 16, 1, ds.voxel_size,
                                    ds.point_cloud_range)
    state = state_dict_from_jax({c: {"point_head": t}
                                 for c, t in _np(v).items()})
    head.load_state_dict({k.split(".", 1)[1]: t for k, t in state.items()},
                         strict=True)
    head.train()
    leaf = torch.tensor(feats, requires_grad=True)
    out = head({"point_features": leaf,
                "point_coords": inp["point_coords"],
                "gt_boxes": inp["gt_boxes"]})
    out["loss"].backward()
    assert set(out["tb_dict"]) == set(tb)
    for k, t in tb.items():
        assert abs(float(out["tb_dict"][k].detach()) - float(t)) \
            <= RTOL * float(t), k
    _check_params(head, jgp, "point_head")
    _close(leaf.grad, jgf, "point_features")
    stats = state_dict_from_jax({"batch_stats": {"point_head": _np(
        mut["batch_stats"])}})
    buffers = dict(head.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name.split(".", 1)[1]] - s).abs().max())
        assert err <= ts.STATS_TOL * max(1.0, float(s.abs().max())), name
    return head, jhead, v, tb


def test_part_targets_and_point_losses_match_reference(two_stage):
    r, inp = two_stage, two_stage["inp"]
    jcfg, pcfg = common.configs(NAME)
    with pytest.MonkeyPatch.context() as mp:
        ts.one_class_point_labels(mp)
        v = {c: r["vars"][c]["point_head"] for c in ("params",
                                                     "batch_stats")}
        head, jhead, v, tb = _point_head_case(
            r, pcfg.MODEL.POINT_HEAD, jcfg.MODEL.POINT_HEAD, v)
        assert float(tb["point_part_loss"]) > 0.1
        xyz, bidx = head.point_xyz(inp["point_coords"])
        gt = inp["gt_boxes"].float()
        labels, box_idx = assign_point_boxes(xyz, bidx, gt, 1,
                                             head.extra_width)
        jl, jb = jhead.apply(v, jnp.asarray(xyz.numpy()),
                             jnp.asarray(bidx.numpy().astype(np.int32)),
                             jnp.asarray(gt.numpy()),
                             tuple(head.extra_width),
                             method="assign_targets")
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(box_idx.numpy(), np.asarray(jb))
        assert (labels > 0).sum() > 100
        m = gt.shape[1]
        gt_of_point = gt.reshape(-1, gt.shape[-1])[bidx.clamp_min(0) * m
                                                   + box_idx]
        want = np.asarray(jhead.apply(
            v, jnp.asarray(xyz.numpy()), jnp.asarray(bidx.numpy()),
            jnp.asarray(box_idx.numpy()), jnp.asarray(labels.numpy()),
            jnp.asarray(gt.numpy()), method="_part_targets"))
        got = head.part_targets(xyz, gt_of_point, labels).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (want > 0).any(1).sum() > 100

        # the box branch, on a config that asks for it
        for cfg in (jcfg.MODEL.POINT_HEAD, pcfg.MODEL.POINT_HEAD):
            cfg.REG_FC = [16]
            cfg.TARGET_CONFIG.BOX_CODER = "PointResidualCoder"
            cfg.TARGET_CONFIG.BOX_CODER_CONFIG = EDict(
                {"use_mean_size": True, "mean_size": MEAN_SIZE})
        _, _, _, tb = _point_head_case(r, pcfg.MODEL.POINT_HEAD,
                                       jcfg.MODEL.POINT_HEAD, None)
        assert float(tb["point_box_loss"]) > 0.1


def test_parta2_head_train_matches_reference(two_stage):
    r, inp = two_stage, two_stage["inp"]
    jcfg = common.configs(NAME)[0]
    ds = r["port"].dataset
    jhead = JaxPartA2FCHead(model_cfg=jcfg.MODEL.ROI_HEAD, input_channels=16,
                            num_class=1, voxel_size=tuple(ds.voxel_size),
                            point_cloud_range=tuple(ds.point_cloud_range))
    v = {c: r["vars"][c]["roi_head"] for c in ("params", "batch_stats")}
    keys = ("point_features", "point_part_offset", "point_cls_scores")
    feats = {k: inp[k].detach().numpy() for k in keys}
    fixed = {k: jnp.asarray(inp[k].numpy())
             for k in ("rois", "roi_labels", "gt_boxes", "point_coords")}

    def loss_fn(p, f):
        out, mut = jhead.apply({"params": p, "batch_stats": v["batch_stats"]},
                               dict(fixed, **f), train=True,
                               mutable=["batch_stats"])
        tb = out["tb_dict"]
        return out["loss"], (tb["rcnn_cls_loss"], tb["rcnn_reg_loss"], mut)
    with pytest.MonkeyPatch.context() as mp:
        own_frame_avg_pool(mp)
        (_, (jcls, jreg, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(
            v["params"], {k: jnp.asarray(f) for k, f in feats.items()})

    head = copy.deepcopy(r["port"].roi_head).train()
    head.zero_grad()
    leaves = {k: torch.tensor(f, requires_grad=True)
              for k, f in feats.items()}
    bd = {k: inp[k] for k in ("rois", "roi_labels", "gt_boxes",
                              "point_coords")}
    out = head(dict(bd, **leaves))
    out["loss"].backward()
    tb = out["tb_dict"]
    assert float(jreg) > 0.01
    for ours, theirs in ((tb["rcnn_cls_loss"], jcls),
                         (tb["rcnn_reg_loss"], jreg)):
        assert abs(float(ours.detach()) - float(theirs)) \
            <= RTOL * float(theirs)
    # a cell's max tied at 0 splits its gradient among the tied rows: the
    # reference's among the other frames' zeroed rows too; the UNet's
    # features are post-ReLU, so the gradient at a 0 goes no further
    pos = feats["point_features"] > 0
    _close(leaves["point_features"].grad * torch.from_numpy(pos),
           np.asarray(jgf["point_features"]) * pos, "point_features")
    for k in keys[1:]:
        _close(leaves[k].grad, jgf[k], k)
    _check_params(head, jgp, "roi_head")
    stats = state_dict_from_jax({"batch_stats": {"roi_head": _np(
        mut["batch_stats"])}})
    buffers = dict(head.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name.split(".", 1)[1]] - s).abs().max())
        assert err <= ts.STATS_TOL * max(1.0, float(s.abs().max())), name


def thread_spread(model, raw, grads):
    """The port's own move when the same step runs on 1 and on 4 threads
    (CPU reductions in another order) against its ``grads``: per
    parameter the larger max |dg|."""
    threads = torch.get_num_threads()
    moved = {n: 0.0 for n in grads}
    try:
        for t in (1, 4):
            torch.set_num_threads(t)
            _, _, m = ts.port_step(model, raw)
            for n, p in m.named_parameters():
                moved[n] = max(moved[n], float((p.grad - grads[n]).abs()
                                               .max()))
    finally:
        torch.set_num_threads(threads)
    return moved


def test_train_step_matches_reference(two_stage):
    r = two_stage
    port = ts.port_step(r["port"], r["raw"])
    assert set(port[1]) == ts.TB_KEYS | {"point_cls_loss", "point_part_loss"}
    assert port[1]["rcnn_reg_loss"] > 0.01
    noise = ts.self_spread(r["port"], r["raw"])
    order = thread_spread(r["port"], r["raw"],
                          {n: p.grad for n, p in port[2].named_parameters()})
    ts.check_step(r, r["want"], port, {n: max(v, order[n])
                                       for n, v in noise.items()},
                  MAX_SPREAD_TENSORS)
    assert r["port"].dense_head.conv_box.weight.grad is None


@pytest.mark.parametrize("name", ["parta2_tiny", "second_iou_tiny"])
def test_train_cli_new_two_stage(tmp_path, name):
    """``python -m q3d_tpu_torch.tools.train`` on the CPU: one epoch of 2
    frames at batch 2 (the yaml's adam_onecycle, GRAD_NORM_CLIP 10), a
    finite loss and ``checkpoint_epoch_1.pth``."""
    import shutil
    from q3d_tpu_torch.tools import train as train_cli
    tag = f"test_{tmp_path.name}"
    run_dir = ROOT / "output" / "cfgs" / "synthetic_models" / name / tag
    try:
        ckpt_dir, hist = train_cli.main([
            "--cfg_file", str(CFG_DIR / f"{name}.yaml"), "--extra_tag", tag,
            "--device", "cpu", "--fix_random_seed", "--epochs", "1",
            "--set", "DATA_CONFIG.NUM_FRAMES", "2"])
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
        assert (ckpt_dir / "checkpoint_epoch_1.pth").is_file()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for d in run_dir.parents:              # the empty directories above
            if d == ROOT / "output" or not d.is_dir() or any(d.iterdir()):
                break
            d.rmdir()
