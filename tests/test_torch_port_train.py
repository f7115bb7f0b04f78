"""PyTorch port vs the JAX package: the training pieces that need no model.

On the same numpy inputs:
  * the learning-rate schedules (one-cycle, warmup cosine, step decay) at a
    sweep of steps, within 1e-7 relative; one ``adamw`` and one ``sgd``
    update on equal gradients, within 1e-6; optax's ``clip_by_global_norm``
    (inside the optimizer) and the train step's own clip;
  * CenterHead's target assignment (heatmap, boxes, inds, mask) and the
    focal, L1 and per-head losses, within 1e-6;
  * the sparse conv's backward (the plain version over the inverse book,
    as the card runs it) against ``jax.grad`` of the reference's
    ``engine.gather_conv`` for a SubM and a strided conv: dX and dW within
    1e-5 of each tensor's largest value; the inverse book equal to one
    built by hand;
  * the train mode of the sparse and the dense BatchNorm: outputs and
    running statistics;
and, port only: checkpoint save, rotation and resume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models.dense_heads.center_head import CenterHead as JaxCenterHead
from q3d_tpu.ops.spconv import engine as jax_engine
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.ops.spconv.sparse_tensor import (
    SparseConvTensor as JaxSparseConvTensor)
from q3d_tpu.optimization import build_optimizer as jax_build_optimizer
from q3d_tpu.optimization import build_schedule as jax_build_schedule
from q3d_tpu.utils import loss_utils as jax_loss

from q3d_tpu_torch.config import EDict, cfg_from_yaml_file
from q3d_tpu_torch.models.dense_heads.center_head import CenterHead
from q3d_tpu_torch.models.layers import BatchNorm
from q3d_tpu_torch.ops.spconv import SparseConvTensor, engine
from q3d_tpu_torch.ops.spconv.gather_conv import sparse_gather_conv
from q3d_tpu_torch.ops.spconv.modules import SparseBatchNorm
from q3d_tpu_torch.optimization import build_optimizer, build_schedule
from q3d_tpu_torch.train_utils import update
from q3d_tpu_torch.utils import checkpoint as ckpt_utils
from q3d_tpu_torch.utils import loss_utils

from test_torch_port_centerpoint import CFG_DIR
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

OPTIM = {
    "onecycle": {"OPTIMIZER": "adam_onecycle", "LR": 0.003,
                 "WEIGHT_DECAY": 0.01, "PCT_START": 0.4, "DIV_FACTOR": 10,
                 "GRAD_NORM_CLIP": 10},
    "cosine": {"OPTIMIZER": "sgd_cosine", "LR": 0.02, "WEIGHT_DECAY": 1e-4},
    "step": {"OPTIMIZER": "sgd", "LR": 0.01, "WEIGHT_DECAY": 1e-4,
             "MOMENTUM": 0.9, "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1,
             "LR_CLIP": 1e-5, "GRAD_NORM_CLIP": 10},
}


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_schedules_and_optimizers_match_optax():
    """LR at a sweep of steps (within 1e-7 relative, each step), one adamw
    and one sgd update on equal gradients with and without the global clip
    firing (within 1e-6), and the train step's own clip."""
    for name, total in (("onecycle", 100), ("onecycle", 2400),
                        ("cosine", 1000), ("step", 60)):
        cfg = OPTIM[name]
        ref = jax_build_schedule(JaxEDict(cfg), total)
        mine = build_schedule(EDict(cfg), total)
        for i in sorted({*range(0, total + 3, max(total // 37, 1)),
                         total - 2, total - 1, total, 39, 40, 41}):
            r, v = float(ref(i)), float(mine(i))
            assert abs(v - r) <= 1e-7 * abs(r), (name, total, i, v, r)

    rng = np.random.RandomState(0)
    shapes = {"a": (27, 16, 32), "b": (32,), "c": (8, 8, 3, 3)}
    params = {k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in shapes.items()}
    for name in ("onecycle", "step"):
        for gscale in (1e-3, 10.0):          # the global clip quiet / firing
            grads = {k: (gscale * rng.normal(0, 1, s)).astype(np.float32)
                     for k, s in shapes.items()}
            tx, _ = jax_build_optimizer(JaxEDict(OPTIM[name]), 100)
            jp = {k: jnp.asarray(v) for k, v in params.items()}
            upd, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                               tx.init(jp), jp)
            ref = optax.apply_updates(jp, upd)
            tp = {k: torch.nn.Parameter(torch.tensor(v))
                  for k, v in params.items()}
            opt = build_optimizer(tp.values(), EDict(OPTIM[name]), 100)
            for k, p in tp.items():
                p.grad = torch.tensor(grads[k])
            opt.step()
            for k in shapes:
                err = np.abs(tp[k].detach().numpy() - np.asarray(ref[k])).max()
                assert err <= 1e-6, (name, gscale, k, err)

    # the train step's own clip, g * min(1, c / (|g| + 1e-6))
    for gscale in (1e-3, 10.0):
        grads = {k: (gscale * rng.normal(0, 1, s)).astype(np.float32)
                 for k, s in shapes.items()}
        gn = optax.global_norm({k: jnp.asarray(v) for k, v in grads.items()})
        scale = jnp.minimum(1.0, 10.0 / (gn + 1e-6))
        tp = {k: torch.nn.Parameter(torch.tensor(v))
              for k, v in params.items()}
        opt = build_optimizer(tp.values(), EDict(
            {"OPTIMIZER": "sgd", "LR": 0.0, "MOMENTUM": 0.0}), 1)
        for k, p in tp.items():
            p.grad = torch.tensor(grads[k])
        update(opt, 10.0)
        for k, p in tp.items():
            want = np.asarray(jnp.asarray(grads[k]) * scale)
            assert _max_rel(p.grad.numpy(), want) <= 1e-6, (gscale, k)
            np.testing.assert_array_equal(p.detach().numpy(), params[k])


def _head_pair():
    jcfg = jax_cfg_from_yaml(str(CFG_DIR / "centerpoint_tiny.yaml"), JaxEDict())
    cfg = cfg_from_yaml_file(str(CFG_DIR / "centerpoint_tiny.yaml"), EDict())
    names = tuple(cfg.CLASS_NAMES)
    pcr = (0.0, -19.2, -3.0, 38.4, 19.2, 1.0)
    vs = (0.3, 0.3, 4.0)
    grid = (128, 128, 1)
    jhead = JaxCenterHead(model_cfg=jcfg.MODEL.DENSE_HEAD, input_channels=64,
                          num_class=3, class_names=names, grid_size=grid,
                          point_cloud_range=pcr, voxel_size=vs)
    head = CenterHead(cfg.MODEL.DENSE_HEAD, 64, 3, names, grid, pcr, vs)
    return jhead, head, jcfg.MODEL.DENSE_HEAD


def test_center_head_targets_and_losses_match_reference():
    """Seeded gt_boxes (zero-padded, every class, some boxes on the range's
    edge) and predictions: the targets of each head, the focal and L1
    losses and ``get_loss_one_head`` within 1e-6."""
    jhead, head, jcfg = _head_pair()
    rng = np.random.RandomState(1)
    b, m, h, w = 2, 32, 16, 16
    gt = np.zeros((b, m, 8), np.float32)
    for i, n in enumerate((20, 13)):
        gt[i, :n, 0] = rng.uniform(-2.0, 40.0, n)
        gt[i, :n, 1] = rng.uniform(-21.0, 21.0, n)
        gt[i, :n, 2] = rng.uniform(-2.0, 0.0, n)
        gt[i, :n, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
        gt[i, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[i, :n, 7] = rng.randint(1, 4, n)
    for idx, ids in enumerate(head.class_id_mapping_each_head):
        ref = jax.jit(jax.vmap(lambda g: jhead.apply(
            {}, g, ids, len(ids), (h, w),
            method=JaxCenterHead.assign_targets_one_head)))(jnp.asarray(gt))
        mine = head.assign_targets_one_head(torch.tensor(gt), ids, len(ids),
                                            (h, w))
        for name, r, v in zip(("heatmap", "boxes", "inds", "mask"), ref, mine):
            r = np.asarray(r)
            assert v.shape == r.shape, name
            if name == "heatmap":
                assert r.max() == 1.0 and (r > 0).sum() > 50
            err = np.abs(v.numpy().astype(np.float64) - r).max()
            assert err <= 1e-6, (idx, name, err)

        c = len(ids)
        code = 8
        preds_nhwc = {k: rng.normal(0, 1, (b, h, w, n)).astype(np.float32)
                      for k, n in (("center", 2), ("center_z", 1), ("dim", 3),
                                   ("rot", 2), ("hm", c))}
        target = {k: np.asarray(t) for k, t in
                  zip(("heatmap", "boxes", "inds", "mask"), ref)}
        lw = jcfg.LOSS_CONFIG.LOSS_WEIGHTS
        order = list(jcfg.SEPARATE_HEAD_CFG.HEAD_ORDER)
        r_hm, r_loc = jax.jit(lambda p, t: jhead.apply(
            {}, p, t, order, list(lw.code_weights), lw,
            method=JaxCenterHead.get_loss_one_head))(
            {k: jnp.asarray(v) for k, v in preds_nhwc.items()},
            {k: jnp.asarray(v) for k, v in target.items()})
        preds = {k: torch.tensor(v).permute(0, 3, 1, 2)
                 for k, v in preds_nhwc.items()}
        v_hm, v_loc = head.get_loss_one_head(
            preds, {k: torch.tensor(v) for k, v in target.items()}, order,
            list(lw.code_weights), lw)
        assert abs(float(v_hm) - float(r_hm)) <= 1e-6 * abs(float(r_hm))
        assert abs(float(v_loc) - float(r_loc)) <= 1e-6 * abs(float(r_loc))

        # the two losses on their own, the focal loss with a mask too
        pred = 1 / (1 + np.exp(-preds_nhwc["hm"].transpose(0, 3, 1, 2)))
        mask = (rng.uniform(size=pred.shape) > 0.2).astype(np.float32)
        for mk in (None, mask):
            r = jax_loss.FocalLossCenterNet()(
                jnp.asarray(pred), jnp.asarray(target["heatmap"]),
                None if mk is None else jnp.asarray(mk))
            v = loss_utils.FocalLossCenterNet()(
                torch.tensor(pred), torch.tensor(target["heatmap"]),
                None if mk is None else torch.tensor(mk))
            assert abs(float(v) - float(r)) <= 1e-6 * abs(float(r))
        reg = rng.normal(0, 1, (b, code, h, w)).astype(np.float32)
        r = jax_loss.RegLossCenterNet()(
            jnp.asarray(reg), jnp.asarray(target["mask"]),
            jnp.asarray(target["inds"]), jnp.asarray(target["boxes"]))
        v = loss_utils.RegLossCenterNet()(
            torch.tensor(reg), torch.tensor(target["mask"]),
            torch.tensor(target["inds"]), torch.tensor(target["boxes"]))
        assert abs(float(v) - float(r)) <= 1e-6 * abs(float(r))


def _sparse_input(rng, n_cap=300, n_valid=240, shape=(6, 24, 24), cin=16):
    """A batch-2 sparse tensor with unique random coordinates and padding
    rows, rows sorted by key."""
    flat = rng.choice(2 * int(np.prod(shape)), n_valid, replace=False)
    b, rest = np.divmod(flat, int(np.prod(shape)))
    z, rest = np.divmod(rest, shape[1] * shape[2])
    y, x = np.divmod(rest, shape[2])
    idx = np.full((n_cap, 4), -1, np.int32)
    idx[:n_valid] = np.stack([b, z, y, x], 1)
    feats = rng.normal(0, 1, (n_cap, cin)).astype(np.float32)
    feats[n_valid:] = 0.0
    st = SparseConvTensor(torch.tensor(feats), torch.tensor(idx), shape,
                          2).sort_rows()
    return st


def test_sparse_conv_backward_matches_jax_grad():
    """dX and dW of a SubM (16 -> 32) and a strided (32 -> 64, stride 2)
    conv through the port's autograd Function (the plain version over the
    inverse book) against ``jax.grad`` of the reference's plain conv on the
    same book, within 1e-5 of each tensor's largest value; padding rows
    get a zero gradient; the inverse book equals one built by hand."""
    rng = np.random.RandomState(2)
    for kind, cin, cout in (("subm", 16, 32), ("strided", 32, 64)):
        st = _sparse_input(rng, cin=cin)
        if kind == "subm":
            book = engine.subm_gather_indices(st, 3)
            out_valid = None
        else:
            out_idx, book, _ = engine.sparse_conv_downsample(st, 3, 2, 1)
            out_valid = out_idx[:, 0] >= 0
        n, m = st.capacity, book.shape[0]
        inv = engine.inverse_book(book, n).numpy()
        by_hand = np.full((n, 27), -1, np.int32)
        for r, row in enumerate(book.numpy()):
            for k, g in enumerate(row):
                if 0 <= g < n:
                    assert by_hand[g, k] == -1, "two outputs read one (n, k)"
                    by_hand[g, k] = r
        np.testing.assert_array_equal(inv, by_hand)

        w = (rng.normal(0, 1, (27, cin, cout)) / np.sqrt(27 * cin)).astype(
            np.float32)
        cot = rng.normal(0, 1, (m, cout)).astype(np.float32)
        feats = st.features.numpy()
        jv = None if out_valid is None else jnp.asarray(out_valid.numpy())

        def loss(f, wt):
            out = jax_engine.gather_conv(f, jnp.asarray(book.numpy()), wt,
                                         out_valid=jv)
            return (out * jnp.asarray(cot)).sum()
        rdx, rdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                                  jnp.asarray(w))
        f = torch.tensor(feats, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        out = sparse_gather_conv(f, book, wt, out_valid=out_valid)
        (out * torch.tensor(cot)).sum().backward()
        for name, v, r in (("dX", f.grad, rdx), ("dW", wt.grad, rdw)):
            r = np.asarray(r)
            err = np.abs(v.numpy() - r).max()
            assert err <= 1e-5 * np.abs(r).max(), (kind, name, err)
        pad = ~st.valid.numpy()
        assert pad.any() and np.isfinite(f.grad.numpy()).all()
        assert (f.grad.numpy()[pad] == 0).all()


def test_batchnorm_train_mode_matches_reference():
    """Train mode: the sparse BN (masked two-pass statistics, n/(n-1)
    running variance, momentum 0.01) and the dense BN (flax's fast
    variance, biased running variance; momentum 0.01 and the head's 0.1)
    against the reference's modules: outputs within 1e-5 relative to
    their scale, running statistics within 1e-6."""
    rng = np.random.RandomState(3)
    x = rng.normal(0.5, 2.0, (200, 32)).astype(np.float32)
    valid = rng.uniform(size=200) > 0.3
    idx = np.where(valid[:, None], 0, -1).astype(np.int32).repeat(4, 1)
    ra = {"mean": rng.normal(0, 1, 32).astype(np.float32),
          "var": rng.uniform(0.5, 2, 32).astype(np.float32)}
    scale, bias = (rng.normal(1, 0.1, 32).astype(np.float32),
                   rng.normal(0, 0.1, 32).astype(np.float32))
    jst = JaxSparseConvTensor(features=jnp.asarray(x),
                              indices=jnp.asarray(idx),
                              spatial_shape=(1, 1, 1), batch_size=1)
    ref, mut = jax_spmodules.SparseBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": ra}, jst,
        train=True, mutable=["batch_stats"])
    bn = SparseBatchNorm(32).train()
    bn.load_state_dict({"weight": torch.tensor(scale),
                        "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(ra["mean"]),
                        "running_var": torch.tensor(ra["var"])})
    out = bn(SparseConvTensor(torch.tensor(x), torch.tensor(idx), (1, 1, 1),
                              1))
    r = np.asarray(ref.features)
    assert np.abs(out.features.detach().numpy() - r).max() \
        <= 1e-5 * np.abs(r).max()
    for k, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(
            mut["batch_stats"][k]), rtol=0, atol=1e-6)

    xd = rng.normal(0.3, 1.5, (2, 9, 7, 32)).astype(np.float32)     # NHWC
    for momentum in (0.01, 0.1):
        jbn = jax_layers.BatchNorm(1e-3, momentum)
        bstats = {"bn": {"mean": ra["mean"], "var": ra["var"]}}
        ref, mut = jbn.apply(
            {"params": {"bn": {"scale": scale, "bias": bias}},
             "batch_stats": bstats}, jnp.asarray(xd), train=True,
            mutable=["batch_stats"])
        bn = BatchNorm(32, eps=1e-3, momentum=momentum).train()
        bn.load_state_dict({"weight": torch.tensor(scale),
                            "bias": torch.tensor(bias),
                            "running_mean": torch.tensor(ra["mean"]),
                            "running_var": torch.tensor(ra["var"])})
        out = bn(torch.tensor(xd).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        r = np.asarray(ref)
        assert np.abs(out.detach().numpy() - r).max() \
            <= 1e-5 * np.abs(r).max()
        for k, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(mut["batch_stats"]["bn"][k]), rtol=0,
                atol=1e-6)


def test_checkpoint_save_rotate_resume(tmp_path):
    """pcdet's .pth layout through torch.save; rotation keeps the newest
    ``max_keep``; the newest readable one is found (a truncated newer file
    is skipped); load restores model and optimizer state exactly; the .pth
    import reads its model state."""
    torch.manual_seed(0)

    def make():
        model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                    torch.nn.BatchNorm1d(8))
        return model, build_optimizer(model.parameters(),
                                      EDict(OPTIM["onecycle"]), 10)
    model, opt = make()
    for epoch in range(1, 5):
        model(torch.randn(6, 4)).square().sum().backward()
        opt.step()
        opt.zero_grad()
        ckpt_utils.save_checkpoint(tmp_path / f"checkpoint_epoch_{epoch}.pth",
                                   model, opt, epoch=epoch, it=3 * epoch,
                                   max_keep=2)
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == [
        "checkpoint_epoch_3.pth", "checkpoint_epoch_4.pth"]
    latest = ckpt_utils.find_latest_checkpoint(tmp_path)
    assert latest.name == "checkpoint_epoch_4.pth"
    blob = torch.load(latest, weights_only=True)
    assert set(blob) == {"model_state", "optimizer_state", "epoch", "it",
                         "version"}
    (tmp_path / "checkpoint_epoch_5.pth").write_bytes(latest.read_bytes()[:50])
    assert ckpt_utils.find_latest_checkpoint(tmp_path).name == \
        "checkpoint_epoch_4.pth"

    fresh, fresh_opt = make()
    epoch, it = ckpt_utils.load_checkpoint(latest, fresh, fresh_opt)
    assert (epoch, it) == (4, 12) and fresh_opt.count == opt.count == 4
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    for sa, sb in zip(opt.torch_optimizer.state.values(),
                      fresh_opt.torch_optimizer.state.values()):
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]),
                               torch.as_tensor(sb[k])), k
    imported = ckpt_utils.load_pth_file(latest)
    assert all(torch.equal(imported[k], v)
               for k, v in model.state_dict().items())
