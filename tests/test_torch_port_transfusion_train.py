"""PyTorch port vs the JAX package: training TransFusion-LiDAR, tiny
(``transfusion_tiny.yaml``), batch 2, f32.

The reference cannot differentiate its loss as it stands
(``ROADMAP.md`` §3): its ``compute_loss`` hands the decoded boxes, which
carry a gradient, to ``jax.pure_callback`` for scipy's assignment, and a
pure callback has no JVP.  The assignment is piecewise constant, so the
parity tests wrap ``jax.pure_callback`` (in the test only) to stop the
gradient at its arguments, and record each call's arguments and result.

* one training step from the reference's seeded init (BN statistics 0 and
  1) on two training frames, the same numpy batch on both sides, against
  ``jax.value_and_grad`` of the reference's loss: the loss within 1e-5
  relative, every gradient within 1e-4 of its tensor's largest |g| (the
  position embeddings' first conv biases feed a train-mode BN: rounding
  noise on both sides, ``biases_before_bn``), the BN running statistics
  within 1e-5 (``test_torch_port_train_step.py``'s float tolerances) in
  the head.  The backbones' gradients cannot be held so at this point:
  ReLUs of the 2D backbone take BN
  outputs 2.6e-6 to 6e-6 from their kink, a last-bit difference upstream
  flips one, and the gradients upstream of it move together.  Readings
  (CPU, this batch; relative L2 over every backbone gradient): the port
  against the reference 1.25% (cosine 0.99992); the port against itself
  with its voxel features perturbed by 1e-7 relative, seeds 1-5,
  0.77-1.25% (two seeds give the reference's 1.25% to four digits: the
  same flip), while the head moves by 1e-6.  So the backbones are held
  together, at relative L2 <= 2.5% and cosine >= 0.9998;
* ``hungarian_assignment`` on the arrays the reference's callback got:
  equal to what the callback returned;
* ``compute_loss`` on the reference's recorded predictions (``res``): the
  three terms within 1e-5 relative;
* the reference's faults, pinned on the unpatched reference and not copied:
  ``jax.grad`` of its loss raises; with a ``vel`` branch and gt boxes of 8
  columns its box target takes the class id and cannot meet the 10
  predicted columns, while the port pads the velocity target with 0;
* QAT: a Linear, a Conv1d and a ConvTranspose2d under
  ``transfusion_recipe()``'s SmoothQuant rule, each fed the reference's
  input and output gradient: output and straight-through gradients within
  1e-5 of each tensor's largest value (the reference's SmoothQuant column
  scale patched in, as in ``test_torch_port_train_step.py``); the tiny
  model under the recipe through ``train_step``.
"""

import copy
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.dense_heads import transfusion_head as jth
from q3d_tpu.quant.rules import QuantRules as JaxQuantRules
from q3d_tpu.quant.rules import quant_rules_scope

from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models import load_data_to_device
from q3d_tpu_torch.models.dense_heads.transfusion_head import (
    TransFusionHead, hungarian_assignment)
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant import tensor_quant as port_tensor_quant
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils.weights import state_dict_from_jax

import torch_port_anchor_common as common
from test_torch_port_anchor_train import _frames
from test_torch_port_train_step import SGD, _np, _reference_sq_scale
from test_torch_port_transfusion_quant import _layer_cases, _sq_rule
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LOSS_RTOL, GRAD_RTOL, STATS_TOL = 1e-5, 1e-4, 1e-5
# the step's gradients are read after it: no clip in the optimizer either
SGD_NO_CLIP = {**SGD, "GRAD_NORM_CLIP": 0}
TB_KEYS = ("trans_cls_loss", "trans_bbox_loss", "trans_hm_loss")


def _callback_without_jvp(calls):
    """``jax.pure_callback`` with the gradient stopped at its arguments,
    each call's arguments and result appended to ``calls``."""
    real = jax.pure_callback

    def pure_callback(fn, shape, *args, **kw):
        def recording(*a):
            out = fn(*a)
            calls.append((tuple(np.array(x) for x in a), np.array(out)))
            return out
        return real(recording, shape,
                    *[jax.lax.stop_gradient(x) for x in args], **kw)
    return pure_callback


def _torch_res(res):
    """The reference's ``res`` (numpy, NHWC dense heatmap) -> the port's."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in res.items()}
    out["dense_heatmap"] = out["dense_heatmap"].permute(0, 3, 1, 2)
    return out


@pytest.fixture(scope="module")
def tt():
    """The reference's and the port's tiny TransFusion from one seeded
    init, a training batch of two frames, and the reference's loss,
    tb_dict, gradients and batch statistics on it, with the predictions
    its ``compute_loss`` got and its callback's calls."""
    ref = common.build_for_training("transfusion_tiny")
    _, raw = _frames(ref["cfg"], 2)
    raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    params = ref["vars"]["params"]
    other = {k: v for k, v in ref["vars"].items() if k != "params"}

    def loss_fn(p, b):
        store = {}

        def interceptor(next_fun, args, kwargs, context):
            if context.method_name == "compute_loss":
                store["res"] = args[0]
            return next_fun(*args, **kwargs)
        with fnn.intercept_methods(interceptor):
            out, mut = ref["model"].apply({"params": p, **other}, b,
                                          train=True, mutable=["batch_stats"])
        return out["loss"], (mut, out["tb_dict"], store["res"])
    calls = []
    with mock.patch.object(jax, "pure_callback", _callback_without_jvp(calls)):
        (loss, (mut, tb, res)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jax_load_data_to_device(
                dict(raw, batch_size=2)))
    return {"ref": ref, "raw": raw,
            "batch": load_data_to_device(raw, device="cpu"),
            "init": copy.deepcopy(ref["port"]), "loss": float(loss),
            "tb": {k: float(v) for k, v in tb.items()}, "grads": _np(grads),
            "stats": _np(mut["batch_stats"]), "res": _np(res),
            "calls": calls}


def _global(mine, want, names):
    """(relative L2 of the difference, cosine) over the tensors
    ``names``."""
    num = sum(float((mine[n].double() - want[n].double()).pow(2).sum())
              for n in names)
    den = sum(float(want[n].double().pow(2).sum()) for n in names)
    dot = sum(float((mine[n].double() * want[n].double()).sum())
              for n in names)
    own = sum(float(mine[n].double().pow(2).sum()) for n in names)
    return (num / den) ** 0.5, dot / (den * own) ** 0.5


def test_train_step_matches_reference(tt):
    """One ``train_step`` (sgd, neither clip) against the reference's loss
    and ``jax.grad`` on the same batch: loss and each term within 1e-5
    relative; every gradient of the head within 1e-4 of its tensor's
    largest |g|, but those that are 0 in exact arithmetic (the biases
    before a train-mode BN, ``biases_before_bn``; the key projections'
    biases, which the softmax cancels; the last LayerNorm's bias, which
    the branches' BNs cancel: the reference's below 1e-6 of the model's
    largest), both below 1e-6 of the model's largest; the backbones'
    gradients together within a relative L2 of 2.5% and a cosine of
    0.9998 (see the module docstring); the BN running statistics (the
    head's, the position embeddings' and the backbones') within 1e-5 of
    max(1, scale)."""
    model = tt["ref"]["port"]
    opt = build_optimizer(model.parameters(), EDict(SGD_NO_CLIP), 1)
    loss, tb = train_step(model, tt["batch"], opt, grad_clip=0)
    assert set(tb) == set(tt["tb"]) == set(TB_KEYS)
    for k, v in tb.items():
        assert abs(float(v) - tt["tb"][k]) <= LOSS_RTOL * abs(tt["tb"][k]), k
    assert abs(float(loss) - tt["loss"]) <= LOSS_RTOL * abs(tt["loss"])

    grads = state_dict_from_jax({"params": tt["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    top = max(float(g.abs().max()) for g in grads.values())
    zero = biases_before_bn(model)
    assert len(zero) == 2                # the two position embeddings'
    zero |= {n for n, g in grads.items() if float(g.abs().max()) <= 1e-6 * top}
    assert len(zero) == 5 and all(n.startswith("dense_head.") for n in zero)
    for name, g in grads.items():
        mine = params[name].grad
        if name in zero:
            assert max(float(g.abs().max()), float(mine.abs().max())) \
                <= 1e-6 * top, name
        elif name.startswith("dense_head."):
            err, scale = float((mine - g).abs().max()), float(g.abs().max())
            assert err <= GRAD_RTOL * scale, (name, err, scale)
    backbones = [n for n in grads if not n.startswith("dense_head.")]
    rel_l2, cos = _global({n: params[n].grad for n in backbones}, grads,
                          backbones)
    assert rel_l2 <= 0.025 and cos >= 0.9998, (rel_l2, cos)
    stats = state_dict_from_jax({"batch_stats": tt["stats"]})
    buffers = dict(model.named_buffers())
    assert any("posembed" in n for n in stats)
    for name, s in stats.items():
        err = float((buffers[name] - s).abs().max())
        assert err <= STATS_TOL * max(1.0, float(s.abs().max())), (name, err)


def test_hungarian_assignment_matches_reference(tt):
    """The frames' scores, boxes and gt boxes the reference's callback
    got, stacked, through the port's assignment: equal to what the
    callback returned, frame by frame; most gts matched, most queries
    not."""
    calls = tt["calls"]
    assert len(calls) == 2
    args = [torch.from_numpy(np.stack([c[0][i] for c in calls]))
            for i in range(3)]
    got = hungarian_assignment(*args).numpy()
    want = np.stack([c[1] for c in calls])
    np.testing.assert_array_equal(got, want)
    n_gt = (tt["raw"]["gt_boxes"][..., -1] > 0).sum(1)
    assert ((got >= 0).sum(1) == np.minimum(n_gt, got.shape[1])).all()
    assert (got < 0).any()


def _heads(ref, head_dict=None):
    """The reference's and the port's tiny TransFusionHead (``head_dict``
    replacing its branches); their loss reads no parameter."""
    jcfg, pcfg = common.configs("transfusion_tiny")
    geo = {k: tuple(getattr(ref["port"].dataset, k)) for k in (
        "grid_size", "point_cloud_range", "voxel_size")}
    heads = []
    for cfg, cls in ((jcfg, jth.TransFusionHead), (pcfg, TransFusionHead)):
        if head_dict is not None:
            cfg.MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT = head_dict
        heads.append(cls(model_cfg=cfg.MODEL.DENSE_HEAD, input_channels=128,
                         num_class=3, class_names=tuple(cfg.CLASS_NAMES),
                         **geo))
    return heads


def _reference_loss(jhead, res, gt):
    return jhead.apply({}, {k: jnp.asarray(v) for k, v in res.items()},
                       jnp.asarray(gt), method=jth.TransFusionHead.compute_loss)


def test_loss_terms_match_reference(tt):
    """The port's ``compute_loss`` on the predictions the reference's got:
    each term and the total within 1e-5 relative of the reference's."""
    _, head = _heads(tt["ref"])
    loss, tb = head.compute_loss(_torch_res(tt["res"]),
                                 torch.from_numpy(tt["raw"]["gt_boxes"]))
    for k in TB_KEYS:
        assert abs(float(tb[k]) - tt["tb"][k]) <= LOSS_RTOL * abs(
            tt["tb"][k]), (k, float(tb[k]), tt["tb"][k])
    assert abs(float(loss) - tt["loss"]) <= LOSS_RTOL * abs(tt["loss"])


def test_reference_faults_not_copied(tt):
    """Fault 1: ``jax.grad`` of the unpatched reference's loss raises
    (``Pure callbacks do not support JVP``).  Fault 2: with a ``vel``
    branch (10 predicted columns) on gt boxes of 8 columns the unpatched
    reference's loss raises; the port's box target pads velocity with 0,
    so with zero velocity predictions its box loss equals the reference's
    without the branch."""
    jhead, _ = _heads(tt["ref"])
    res, gt = tt["res"], tt["raw"]["gt_boxes"]

    def loss_of_center(center):
        return _reference_loss(jhead, {**res, "center": center}, gt)[0]
    with pytest.raises(ValueError, match="JVP"):            # while tracing
        jax.jit(jax.grad(loss_of_center))(jnp.asarray(res["center"]))

    head_dict = {**{k: dict(v) for k, v in common.configs("transfusion_tiny")[1]
                    .MODEL.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT.items()},
                 "vel": {"out_channels": 2, "num_conv": 2}}
    jhead_vel, head_vel = _heads(tt["ref"], head_dict)
    res_vel = {**res, "vel": np.zeros(res["center"].shape, np.float32)}
    assert gt.shape[-1] == 8
    with pytest.raises((TypeError, ValueError)):             # while tracing
        jax.jit(lambda r: _reference_loss(jhead_vel, r, gt))(res_vel)
    _, got = head_vel.compute_loss(_torch_res(res_vel), torch.from_numpy(gt))
    want = tt["tb"]["trans_bbox_loss"]          # the reference's, on ``res``
    assert abs(float(got["trans_bbox_loss"]) - want) <= LOSS_RTOL * want


def test_qat_smoothquant_layers_and_train_step(monkeypatch, tt):
    """A Linear, a Conv1d and a ConvTranspose2d under the recipe's dynamic
    SmoothQuant rule: the port's layer fed the reference's input and
    output gradient gives its output, dX and dW within 1e-5 of each
    tensor's largest value; the float layer lands more than 1e-3 away.
    Then the tiny model under ``transfusion_recipe()`` through
    ``train_step`` (the recipe quantizes its Linears, Conv1ds, Conv2ds and
    sparse convs, not the transposed deblock): every quantized layer's
    weight gets a finite nonzero gradient, no quantizer state is a
    parameter."""
    monkeypatch.setattr(port_tensor_quant, "smoothquant_scale",
                        _reference_sq_scale)
    rng = np.random.RandomState(29)
    for kind, jmod, mod, xs, to_port, layout in _layer_cases(rng):
        jrule, rule = _sq_rule(kind, False)
        rules = JaxQuantRules(rules=(jrule,))
        x = jnp.asarray(xs[0])
        with quant_rules_scope(rules):
            v = jmod.init(jax.random.PRNGKey(5), x)

        def ref_fn(xx, kernel):
            with quant_rules_scope(rules):
                return jmod.apply({**v, "params": {**v["params"],
                                                   "kernel": kernel}}, xx)
        out, vjp = jax.vjp(jax.jit(ref_fn), x, v["params"]["kernel"])
        cot = rng.normal(0, 1, out.shape).astype(np.float32)
        dx, dk = vjp(jnp.asarray(cot))
        nhwc = kind == "conv_transpose2d"
        want = [np.asarray(out), np.asarray(dx),
                layout(np.asarray(dk))]
        mod.weight.data = torch.from_numpy(np.ascontiguousarray(
            layout(np.asarray(v["params"]["kernel"]))))
        mod.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))

        def port(quantized):
            xt = to_port(xs[0]).requires_grad_(True)
            mod.rule, mod.weight.grad = None, None
            if quantized:
                mod.rule, mod.calibrating = rule, True
                with torch.no_grad():
                    mod(xt.detach())
                mod.calibrating = False
            y = mod(xt)
            y = y.permute(0, 2, 3, 1) if nhwc else y
            (y * torch.from_numpy(cot)).sum().backward()
            g = xt.grad.permute(0, 2, 3, 1) if nhwc else xt.grad
            return [y.detach().numpy(), g.numpy(), mod.weight.grad.numpy()]
        float_got, got = port(False), port(True)
        for name, g, r, f in zip(("out", "dX", "dW"), got, want, float_got):
            scale = np.abs(r).max()
            assert g.shape == r.shape and scale > 0, (kind, name)
            assert np.abs(g - r).max() <= 1e-5 * scale, (
                kind, name, np.abs(g - r).max() / scale)
            assert np.abs(f - r).max() > 1e-3 * scale, (kind, name)

    monkeypatch.undo()        # the model's step runs the port's own scale
    model = tt["init"]
    port_api.quantize_model(model, port_api.transfusion_recipe(),
                            tt["batch"])
    assert not [n for n, _ in model.named_parameters()
                if "quant" in n or "amax" in n]
    quantized = {n: m for n, m in model.named_modules()
                 if getattr(m, "rule", None) is not None
                 and getattr(m, "weight", None) is not None}
    kinds = {m.QUANT_KIND for m in quantized.values()}
    assert {"linear", "conv1d", "conv2d", "subm_conv3d"} <= kinds, kinds
    opt = build_optimizer(model.parameters(), EDict(SGD), 1)
    loss, _ = train_step(model, tt["batch"], opt)
    assert torch.isfinite(loss)
    for n, m in quantized.items():
        assert torch.isfinite(m.weight.grad).all() \
            and float(m.weight.grad.abs().max()) > 0, n
