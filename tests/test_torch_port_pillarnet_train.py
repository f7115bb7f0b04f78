"""PyTorch port vs the JAX package: training PillarNet, tiny
(``pillarnet_tiny.yaml``), batch 2, f32.

* one training step from the reference's seeded init (BN statistics 0 and
  1) on two training frames, the same numpy batch on both sides, against
  ``jax.value_and_grad`` of the reference's loss (jitted): the loss within
  1e-5 relative, the BN running statistics within 1e-5 of max(1, scale)
  and every gradient within 1e-4 of its tensor's largest |g|
  (``test_torch_port_train_step.py``'s float tolerances), or, where the
  port's own step moves that gradient by more than that when the points'
  intensity is scaled by 1 +/- 1e-6 noise (their pillars unchanged),
  within twice that move, for at most half of the tensors: a pre-ReLU
  value of ~1e-6 in conv3 takes opposite signs in the two packages on
  this batch (measured), as ``test_torch_port_multihead_train.py`` holds
  its step.  Every sparse conv runs its input gradient over the inverse
  book, the first one too: its input, the VFE's pooled rows, carries the
  PFN's gradient.  The biases before a train-mode BN (the head's convs)
  have gradient 0 in exact arithmetic and are held below 1e-6 of the
  model's largest on both sides (``biases_before_bn``);
* PillarRes18BackBone8x's own pieces in train mode, fed one input: the
  strided 128 -> 256 conv and a residual block of biased SubM convs on
  256 channels, output and every gradient within 1e-4 of their scale
  (the residual blocks' biases feed a BN: below 1e-6 of the largest);
* the segment max's gradient against the reference's scatter-max JVP:
  both share a row's gradient evenly among its tied maxima (a point
  duplicated inside a pillar), and ReLU's zeros tied at 0 carry none;
  the values and gradients within 1e-6 (f32, the same sums), the VFE's
  linear weight gradient within 1e-5 of its scale.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from q3d_tpu.datasets import build_dataloader as jax_build_dataloader
from q3d_tpu.models import build_network as jax_build_network
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.models.backbones_3d import spconv_backbone_2d as jax_sp2d
from q3d_tpu.models.backbones_3d.vfe import dynamic_pillar_vfe as jax_dpv
from q3d_tpu.ops.spconv import SparseConvTensor as JaxSparseConvTensor

import torch_port_anchor_common as common
from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models import build_network, load_data_to_device
from q3d_tpu_torch.models.backbones_3d.spconv_backbone import (
    SparseBasicBlock, _SparseConvBNReLU)
from q3d_tpu_torch.models.backbones_3d.vfe.segments import segment_max
from q3d_tpu_torch.ops.spconv import SparseConvTensor
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_anchor_train import _frames
from test_torch_port_train_step import SGD, _np
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
LOSS_RTOL, GRAD_RTOL, STATS_TOL = 1e-5, 1e-4, 1e-5
SGD_NO_CLIP = {**SGD, "GRAD_NORM_CLIP": 0}
# at most half of the 97 gradients (the biases before a BN apart) may take
# the port's own spread as their tolerance: on this batch a pre-ReLU value
# of ~1e-6 in conv3 flips between the packages, and 41 of them move by more
# than 1e-4 of their scale under the noise (measured), each within twice
# that move of the reference
MAX_SPREAD_TENSORS = 48


def _build(backbone):
    """The tiny PillarNet with ``backbone`` on both sides from one seeded
    init (``torch_port_anchor_common._seeded_variables``), and two training
    frames -> (reference model, variables, port model, numpy batch)."""
    jcfg, pcfg = common.configs("pillarnet_tiny")
    for cfg in (jcfg, pcfg):
        cfg.MODEL.BACKBONE_3D.NAME = backbone
    ds, raw = _frames(pcfg, 2)
    raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    jds = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                               batch_size=1, training=False)[0]
    jmodel = jax_build_network(jcfg.MODEL, len(jcfg.CLASS_NAMES), jds)
    jbatch = jax_load_data_to_device(dict(raw, batch_size=2))
    variables = common._seeded_variables(jax.eval_shape(
        lambda k, b: jmodel.init(k, b, train=False), jax.random.PRNGKey(0),
        jbatch))
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), ds, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model, raw


def _reference_step(jmodel, variables, raw):
    jbatch = jax_load_data_to_device(dict(raw, batch_size=2))
    params = variables["params"]
    other = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p, b):
        out, mut = jmodel.apply({"params": p, **other}, b, train=True,
                                mutable=["batch_stats"])
        return out["loss"], (mut, out["tb_dict"])
    (loss, (mut, tb)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jbatch)
    return float(loss), {k: float(v) for k, v in tb.items()}, _np(grads), \
        _np(mut["batch_stats"])


def _self_spread(model, raw, eps=1e-6):
    """The port's own gradients with the points' intensity scaled by (1 +/-
    eps noise) (their coordinates, and so the pillars, stay as they are):
    per parameter, the larger distance of the two from the unperturbed
    step's -> {name: max |dg|}."""
    grads = []
    for sign in (0.0, 1.0, -1.0):
        m = copy.deepcopy(model)
        noise = np.random.RandomState(1).standard_normal(
            raw["points"].shape[:2])
        pts = raw["points"].copy()
        pts[..., 3] *= 1 + sign * eps * noise
        train_step(m, load_data_to_device(dict(raw, points=pts), device="cpu"),
                   build_optimizer(m.parameters(), EDict(SGD_NO_CLIP), 1),
                   grad_clip=0)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    return {n: max(float((grads[k][n] - g).abs().max()) for k in (1, 2))
            for n, g in grads[0].items()}


def test_train_step_matches_reference():
    jmodel, variables, model, raw = _build("PillarBackBone8x")
    assert raw["points"].shape[0] == 2 and raw["points_mask"].sum() > 10000
    jloss, jtb, want, stats_want = _reference_step(jmodel, variables, raw)
    spread = _self_spread(model, raw)
    opt = build_optimizer(model.parameters(), EDict(SGD_NO_CLIP), 1)
    loss, tb = train_step(model, load_data_to_device(raw, device="cpu"), opt,
                          grad_clip=0)
    assert set(tb) == set(jtb) and len(tb) == 2
    for k, v in tb.items():
        assert abs(float(v) - jtb[k]) <= LOSS_RTOL * abs(jtb[k]), k
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)

    grads = state_dict_from_jax({"params": want})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    zero = biases_before_bn(model)
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
        flips += spread[name] > GRAD_RTOL * scale
    assert flips <= MAX_SPREAD_TENSORS, flips
    # the PFN takes a gradient through the pooled rows and the first conv
    assert float(params["vfe.pfn_layers.0.linear.weight"].grad.abs().max()) > 0
    stats = state_dict_from_jax({"batch_stats": stats_want})
    buffers = dict(model.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name] - s).abs().max())
        assert err <= STATS_TOL * max(1.0, float(s.abs().max())), (name, err)


def test_residual_block_train_matches_reference():
    """PillarRes18BackBone8x's own pieces in train mode, fed one input:
    its strided 128 -> 256 SparseConv2d and a residual block
    (``SparseBasicBlock`` with biased SubM convs, train-mode BNs, the
    identity) on 256 channels, against ``jax.value_and_grad`` of the
    reference's ``_S2`` + ``Sparse2DBasicBlock``: the output, the input's
    and every parameter's gradient within 1e-4 of their scale (the convs'
    biases: below 1e-6 of the largest on both sides), the BN running
    statistics within 1e-5."""
    rng = np.random.RandomState(11)
    n_cap, n_valid, shape = 1500, 1100, (48, 40)
    cells = rng.choice(2 * shape[0] * shape[1], n_valid, replace=False)
    b, rest = np.divmod(cells, shape[0] * shape[1])
    y, x = np.divmod(rest, shape[1])
    idx = np.full((n_cap, 3), -1, np.int32)
    idx[:n_valid] = np.stack([b, y, x], 1)
    idx = idx[np.argsort(np.where(idx[:, 0] >= 0, (idx[:, 0] * shape[0]
                                                   + idx[:, 1]) * shape[1]
                                  + idx[:, 2], 2 ** 30), kind="stable")]
    feats = np.maximum(rng.randn(n_cap, 128), 0).astype(np.float32)
    feats[idx[:, 0] < 0] = 0.0

    class Pair(fnn.Module):
        @fnn.compact
        def __call__(self, st):
            st = jax_sp2d._S2(256, 3, 2, 1, "spconv", "spconv4",
                              name="down")(st, {}, True)
            return jax_sp2d.Sparse2DBasicBlock(256, "res4", name="res")(
                st, {}, True)
    jst = JaxSparseConvTensor(features=jnp.asarray(feats),
                              indices=jnp.asarray(idx), spatial_shape=shape,
                              batch_size=2, sorted_rows=True)
    pair = Pair()
    v = common._seeded_variables(jax.eval_shape(
        lambda k, s: pair.init(k, s), jax.random.PRNGKey(0), jst), seed=5)
    v["params"]["res"]["conv1"]["bias"] = rng.randn(256).astype(np.float32)
    out_shape = jax.eval_shape(lambda v, s: pair.apply(
        v, s, mutable=["batch_stats"])[0].features, v, jst).shape
    cot = rng.randn(*out_shape).astype(np.float32)

    def loss_fn(p, f):
        out, mut = pair.apply({"params": p, "batch_stats": v["batch_stats"]},
                              jst.replace(features=f),
                              mutable=["batch_stats"])
        return (out.features * out.valid[:, None] * cot).sum(), (out, mut)
    (_, (jout, mut)), (jgp, jgf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(v["params"],
                                                jnp.asarray(feats))

    down = _SparseConvBNReLU(128, 256, 3, 2, 1, "spconv", "spconv4", nd=2)
    res = SparseBasicBlock(256, "res4", use_bias=True, nd=2)
    for mod, sub in ((down, "down"), (res, "res")):
        state = state_dict_from_jax({c: {"backbone_3d": {"conv4_0": t[sub]}}
                                     for c, t in _np(v).items()})
        mod.load_state_dict({k.split(".", 3)[3]: t
                             for k, t in state.items()}, strict=True)
        mod.train()
    f = torch.tensor(feats, requires_grad=True)
    st = SparseConvTensor(f, torch.from_numpy(idx), shape, 2, sorted_rows=True)
    cache = {}
    out = res(down(st, cache), cache)
    valid = out.valid
    assert 0 < int(valid.sum()) < valid.numel()
    (out.features * valid[:, None] * torch.from_numpy(cot)).sum().backward()

    jv = np.asarray(jout.valid)
    np.testing.assert_array_equal(valid.numpy(), jv)
    want = np.asarray(jout.features)[jv]
    assert float(np.abs(out.features.detach().numpy()[jv] - want).max()) \
        <= GRAD_RTOL * float(np.abs(want).max())
    jgf = np.asarray(jgf)
    assert float(np.abs(f.grad.numpy() - jgf).max()) \
        <= GRAD_RTOL * float(np.abs(jgf).max())
    grads = {"params": _np(jgp)}
    zero = {"conv1.bias", "conv2.bias"}
    top = max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(
        grads))
    for mod, sub in ((down, "down"), (res, "res")):
        named = dict(mod.named_parameters())
        for key, g in state_dict_from_jax(
                {"params": {"backbone_3d": {"conv4_0": grads["params"][
                    sub]}}}).items():
            name = key.split(".", 3)[3]
            mine = named[name].grad
            err, scale = float((mine - g).abs().max()), float(g.abs().max())
            if sub == "res" and name in zero:
                assert max(scale, float(mine.abs().max())) <= 1e-6 * top
                continue
            assert scale > 0 and err <= GRAD_RTOL * scale, (sub, name, err)
    for sub, mod in (("down", down), ("res", res)):
        stats = state_dict_from_jax(
            {"batch_stats": {"backbone_3d": {"conv4_0": _np(
                mut["batch_stats"])[sub]}}})
        buffers = dict(mod.named_buffers())
        for key, s in stats.items():
            name = key.split(".", 3)[3]
            err = float((buffers[name] - s).abs().max())
            assert err <= STATS_TOL * max(1.0, float(s.abs().max())), name


def test_segment_max_gradient_ties_match_reference():
    """The segment max alone, and the VFE on a batch with a point duplicated
    inside a pillar: values and gradients against ``jax.grad`` of the
    reference's ``.at[].max`` (after a ReLU, as the PFN runs it)."""
    rng = np.random.RandomState(7)
    n, rows, c = 40, 9, 5
    y = rng.randn(n, c).astype(np.float32)
    ids = rng.randint(0, rows - 1, n)             # row rows - 1 stays empty
    y[5], ids[5] = y[3], ids[3]                   # a positive tie, 3 and 5
    y[7] = -np.abs(y[7])                          # ReLU's zeros tie at 0
    ids[7] = ids[3]
    cot = rng.randn(rows, c).astype(np.float32)

    def jax_fn(yv):
        x = jax.nn.relu(yv)
        m = jnp.full((rows, c), -jnp.inf).at[jnp.asarray(ids)].max(x)
        return (jnp.where(jnp.isfinite(m), m, 0.0) * cot).sum()
    jval, jgrad = jax.value_and_grad(jax_fn)(jnp.asarray(y))
    yt = torch.tensor(y, requires_grad=True)
    out = segment_max(torch.relu(yt), torch.from_numpy(ids), rows - 1)
    val = (out * torch.from_numpy(cot)).sum()
    val.backward()
    assert not out[rows - 1].any()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    g = yt.grad.numpy()
    both = (y[3] > 0) & (g[3] != 0)
    assert both.any() and np.array_equal(g[3][both], g[5][both])

    # the VFE: frame 0's first point duplicated into a padded slot
    _, pcfg = common.configs("pillarnet_tiny")
    ds, loader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    raw = next(iter(loader))
    k = int(raw["points_mask"][0].sum())
    raw["points"][0, k] = raw["points"][0, 0]
    raw["points_mask"][0, k] = True
    model = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), ds, device="cpu")
    vfe = model.vfe
    jvfe = jax_dpv.DynamicPillarVFE(pcfg.MODEL.VFE, 4, vfe.voxel_size,
                                    vfe.point_cloud_range, vfe.grid_size,
                                    vfe.max_pillars)
    jbatch = jax_load_data_to_device(dict(raw))
    v = jvfe.init(jax.random.PRNGKey(0), jbatch, False)
    w = np.asarray(v["params"]["pfn_linear_0"]["kernel"])
    pcot = rng.randn(vfe.max_pillars, 32).astype(np.float32)

    def jax_vfe(kernel):
        p = {"params": {**v["params"], "pfn_linear_0": {"kernel": kernel}},
             "batch_stats": v["batch_stats"]}
        return (jvfe.apply(p, dict(jbatch), False)["pillar_features"]
                * pcot).sum()
    jval, jgrad = jax.jit(jax.value_and_grad(jax_vfe))(jnp.asarray(w))
    state = state_dict_from_jax({c_: {"vfe": t} for c_, t in _np(v).items()})
    vfe.load_state_dict({k_.split(".", 1)[1]: t for k_, t in state.items()})
    vfe.eval()
    out = vfe(load_data_to_device(raw, device="cpu"))["pillar_features"]
    val = (out * torch.from_numpy(pcot)).sum()
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    mine = vfe.pfn_layers[0].linear.weight.grad.numpy().T
    assert np.abs(mine - np.asarray(jgrad)).max() \
        <= 1e-5 * np.abs(np.asarray(jgrad)).max()
