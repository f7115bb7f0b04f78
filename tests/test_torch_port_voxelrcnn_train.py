"""PyTorch port vs the JAX package: training Voxel R-CNN, tiny
(``voxelrcnn_tiny.yaml``), batch 2, f32 (``torch_port_two_stage_train_common``
builds both sides and says how the reference is patched in the test).

* ``VoxelRCNNHead``'s train branch alone, fed the port's training inputs
  (the proposals, gt boxes with planted rows, the sparse stages x_conv2-4)
  on both sides: the sampled rois' losses, the head's parameter gradients
  and the stages' feature gradients within 1e-5 of their scale (x_conv2's
  0 on both sides: no voxel centre within its 0.4 m radius of a grid
  point on this batch), the BN statistics within 1e-5;
* one training step from the reference's seeded init against
  ``jax.value_and_grad`` of the patched reference, held as
  ``test_torch_port_pvrcnn_train.py`` holds PV-RCNN's (the same
  ReLU flip in the 3D backbone: the first 17 convs' and BNs' gradients
  take the port's own spread, measured);
* the port's train CLI on both tiny two-stage yamls on the CPU: one epoch
  of two frames at batch 2, finite losses, the checkpoint written.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models.roi_heads import VoxelRCNNHead as JaxVoxelRCNNHead
from q3d_tpu.ops.spconv import SparseConvTensor as JaxSparseConvTensor

import torch_port_two_stage_train_common as ts
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_centerpoint import CFG_DIR, ROOT
from test_torch_port_train_step import _np
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
NAME = "voxelrcnn_tiny"
HEAD_RTOL = 1e-5
STAGES = ("x_conv2", "x_conv3", "x_conv4")
# of the gradients (the biases before a BN apart), those that may take the
# port's own spread as their tolerance (17 measured)
MAX_SPREAD_TENSORS = 24


@pytest.fixture(scope="module")
def two_stage():
    with pytest.MonkeyPatch.context() as mp:
        ts.patch_reference(mp)
        r = ts.build(NAME)
        r["want"] = ts.reference_step(r)
    return r


def test_voxelrcnn_head_train_matches_reference(two_stage):
    r = two_stage
    inp = ts.roi_head_inputs(r["port"], r["raw"])
    stages = {k: inp["multi_scale_3d_features"][k] for k in STAGES}
    feats = {k: st.features.detach().numpy() for k, st in stages.items()}
    jcfg = ts.common.configs(NAME)[0]
    ds = r["port"].dataset
    jhead = JaxVoxelRCNNHead(model_cfg=jcfg.MODEL.ROI_HEAD, num_class=1,
                             voxel_size=tuple(ds.voxel_size),
                             point_cloud_range=tuple(ds.point_cloud_range))
    v = {c: r["vars"][c]["roi_head"] for c in ("params", "batch_stats")}
    fixed = {k: jnp.asarray(inp[k].numpy())
             for k in ("rois", "roi_labels", "gt_boxes")}

    def loss_fn(p, f):
        bd = dict(fixed, multi_scale_3d_strides=dict(
            inp["multi_scale_3d_strides"]), multi_scale_3d_features={
            k: JaxSparseConvTensor(
                features=f[k], indices=jnp.asarray(stages[k].indices.numpy()),
                spatial_shape=tuple(stages[k].spatial_shape), batch_size=2)
            for k in STAGES})
        out, mut = jhead.apply({"params": p, "batch_stats": v["batch_stats"]},
                               bd, train=True, mutable=["batch_stats"])
        tb = out["tb_dict"]
        return out["loss"], (tb["rcnn_cls_loss"], tb["rcnn_reg_loss"], mut)
    (_, (jcls, jreg, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        v["params"], {k: jnp.asarray(f) for k, f in feats.items()})

    head = copy.deepcopy(r["port"].roi_head).train()
    head.zero_grad()
    leaves = {k: torch.tensor(f, requires_grad=True) for k, f in feats.items()}
    bd = {k: inp[k] for k in ("rois", "roi_labels", "gt_boxes",
                              "multi_scale_3d_strides")}
    bd["multi_scale_3d_features"] = {
        k: st.replace(features=leaves[k]) for k, st in stages.items()}
    out = head(bd)
    out["loss"].backward()
    tb = out["tb_dict"]
    assert float(jreg) > 0.01
    for ours, theirs in ((tb["rcnn_cls_loss"], jcls),
                         (tb["rcnn_reg_loss"], jreg)):
        assert abs(float(ours.detach()) - float(theirs)) \
            <= HEAD_RTOL * float(theirs)
    # x_conv2's voxel centres lie beyond the 0.4 m radius of every grid
    # point on this batch: its rows take no gradient on either side
    reached = []
    for k in STAGES:
        want = np.asarray(jgf[k])
        mine = np.zeros_like(want) if leaves[k].grad is None \
            else leaves[k].grad.numpy()
        assert np.abs(mine - want).max() <= HEAD_RTOL * max(
            np.abs(want).max(), 1e-30), k
        if np.abs(want).max() > 0:
            reached.append(k)
    assert reached == ["x_conv3", "x_conv4"], reached
    grads = state_dict_from_jax({"params": {"roi_head": _np(jgp)}})
    params = dict(head.named_parameters())
    for name, g in grads.items():
        mine = params[name.split(".", 1)[1]].grad
        scale = float(g.abs().max())
        assert scale > 0 and float((mine - g).abs().max()) \
            <= HEAD_RTOL * scale, name
    stats = state_dict_from_jax({"batch_stats": {"roi_head": _np(
        mut["batch_stats"])}})
    buffers = dict(head.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name.split(".", 1)[1]] - s).abs().max())
        assert err <= ts.STATS_TOL * max(1.0, float(s.abs().max())), name


def test_train_step_matches_reference(two_stage):
    r = two_stage
    port = ts.port_step(r["port"], r["raw"])
    assert set(port[1]) == ts.TB_KEYS and port[1]["rcnn_reg_loss"] > 0.01
    ts.check_step(r, r["want"], port, ts.self_spread(r["port"], r["raw"]),
                  MAX_SPREAD_TENSORS)
    assert r["port"].dense_head.conv_box.weight.grad is None


@pytest.mark.parametrize("name", ["pvrcnn_tiny", "voxelrcnn_tiny"])
def test_train_cli_two_stage(tmp_path, name):
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
