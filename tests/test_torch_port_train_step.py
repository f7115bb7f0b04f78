"""PyTorch port vs the JAX package: CenterPoint training steps.

The trained tiny CenterPoint fixture is loaded on both sides (the JAX
variables straight from its msgpack, carried across with
``state_dict_from_jax``), and one batch of centerpoint_tiny (f32; one
frame in float, two under QAT) goes through the reference's
``make_train_step`` and the port's ``train_step``:
  * float: one step, loss within 1e-5 relative, every gradient within 1e-4
    of its tensor's largest |g| (taken after the step's own clip; the
    reference's optimizer is a transformation that records its input), the
    BN running statistics after the step within 1e-5; it is the first of
    three steps of the ``sgd`` branch (momentum 0.9, linear in the
    gradient, so it can be held over several steps; Adam's first update
    moves every weight by about +-lr whatever the gradient's size, so it is
    held on equal gradients in ``test_torch_port_train.py``): losses within
    1e-4 relative;
  * QAT under ``centerpoint_recipe()`` (dynamic SmoothQuant fake-quant):
    each kind of quantized layer (the sparse conv with per-input-channel
    acts, the dense SmoothQuant conv) fed the same inputs and output
    gradient as the reference's flax module, so that both take the same
    rounding decisions: output, input and weight gradients at the float
    tolerances; and (marked ``slow``) one whole QAT step against the
    reference's, whose gradients are ill-conditioned (see that test);
and the port's train CLI for one epoch on the CPU, then asked again, when
it resumes from its checkpoint and has nothing left to do.

The JAX side compiles once per optimizer and rule set, on first use (a
module fixture per file keeps it so).
"""

import functools
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from q3d_tpu.config import EDict as JaxEDict
from q3d_tpu.models import layers as jax_layers
from q3d_tpu.models import load_data_to_device as jax_load_data_to_device
from q3d_tpu.ops.spconv import modules as jax_spmodules
from q3d_tpu.optimization import build_optimizer as jax_build_optimizer
from q3d_tpu.parallel import make_train_step
from q3d_tpu.quant import api as jax_quant
from q3d_tpu.quant.rules import QuantRules as JaxQuantRules
from q3d_tpu.quant.rules import quant_rules_scope
from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.config import EDict
from q3d_tpu_torch.models import load_data_to_device
from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.ops.spconv import SparseConvTensor, SubMConv3d
from q3d_tpu_torch.optimization import build_optimizer
from q3d_tpu_torch.quant import api as port_quant
from q3d_tpu_torch.quant import tensor_quant as port_tensor_quant
from q3d_tpu_torch.train_utils import MODEL_KEYS, biases_before_bn, \
    train_step
from q3d_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_centerpoint import CFG_DIR, CKPT, ROOT, _jax_model, \
    _port_model
from test_torch_port_fakequant import _calibrate_layer
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

SGD = {"OPTIMIZER": "sgd", "LR": 0.003, "WEIGHT_DECAY": 0.01,
       "MOMENTUM": 0.9, "GRAD_NORM_CLIP": 10}


def _recording(tx):
    """``tx`` that also keeps its input (the gradient after the step's own
    clip) in its state."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params),
                "tx": tx.init(params)}

    def upd(grads, state, params=None):
        updates, inner = tx.update(grads, state["tx"], params)
        return updates, {"g": grads, "tx": inner}
    return optax.GradientTransformation(init, upd)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        jax.device_get(tree)))


# the batch of each case: one frame for the float steps (the cheapest that
# holds them); two for QAT, where a step with 4-bit weights reads well
# beyond the spread of its gradients (tests/torch_port_qat_spread.py)
FRAMES = {"float": 1, "qat": 2}


@pytest.fixture(scope="module")
def ref():
    """The fixture's variables (numpy) and ``case_data(case)``: the numpy
    batch of the case and the reference's results on it (the loss,
    gradients and BN statistics of one step from the fixture, and its
    losses over the steps taken: 3 for "float", the sgd branch; 1 for
    "qat"), computed on first use."""
    with open(CKPT, "rb") as f:
        variables = _np(flax.serialization.msgpack_restore(
            pickle.load(f)["model_state"]))
    done = {}

    def case_data(case):
        if case not in done:
            _, _, jloader, jmodel = _jax_model("centerpoint_tiny",
                                               batch_size=FRAMES[case])
            raw = {k: v for k, v in next(iter(jloader)).items()
                   if k in MODEL_KEYS}
            jbatch = jax_load_data_to_device(raw)
            rules = jax_quant.centerpoint_recipe() if case == "qat" else None
            tx = _recording(jax_build_optimizer(JaxEDict(SGD), 3)[0])
            v = jax.tree_util.tree_map(jnp.asarray, variables)
            state = tx.init(v["params"])
            step = make_train_step(jmodel, tx, grad_clip=10.0, rules=rules)
            losses = []
            for i in range(3 if case == "float" else 1):
                v, state, loss, _ = step(v, state, jbatch)
                losses.append(float(loss))
                if i == 0:
                    want = {"loss": losses[0], "grads": _np(state["g"]),
                            "batch_stats": _np(v["batch_stats"])}
            want["losses"] = losses
            done[case] = raw, want
        return done[case]
    return variables, case_data


def _port(variables):
    _, _, _, model = _port_model("centerpoint_tiny")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _grad_errors(model, want, zero_grad):
    """-> ({name: (max |mine - want|, max |want|)}, global relative L2
    difference, global cosine) over the gradients, the biases of
    ``zero_grad`` apart."""
    grads = state_dict_from_jax({"params": want})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    per, num, den, dot, mine2 = {}, 0.0, 0.0, 0.0, 0.0
    for name, g in grads.items():
        mine = params[name].grad
        per[name] = (float((mine - g).abs().max()), float(g.abs().max()))
        if name not in zero_grad:
            num += float((mine - g).pow(2).sum())
            den += float(g.pow(2).sum())
            dot += float((mine * g).sum())
            mine2 += float(mine.pow(2).sum())
    return per, (num / den) ** 0.5, dot / (den * mine2) ** 0.5


@pytest.mark.parametrize("case", [
    "float", pytest.param("qat", marks=pytest.mark.slow)])
def test_train_step_matches_reference(ref, case):
    """One step from the trained fixture, float and under QAT: loss,
    gradients (after the step's own clip) and BN running statistics.

    float: loss within 1e-5 relative, every gradient within 1e-4 of its
    tensor's largest |g|, the statistics within 1e-5; then two more steps
    of the sgd branch, the three losses within 1e-4 relative.  A conv bias
    right before a train-mode BN has gradient 0 (the BN takes out any
    per-channel constant): both packages' are rounding noise, held below
    1e-6 of the largest gradient of the model.

    qat (``centerpoint_recipe()``, dynamic SmoothQuant, 8 bits; ``slow``:
    a second compiled reference step): the straight-through gradient is a
    function of discrete roundings, so a float difference in the last bit
    of one value can move an activation by a quantization step, and the
    step's gradients with it.  Readings on this batch of two frames (CPU,
    ``tests/torch_port_qat_spread.py --batch-size 2``; the gradients'
    global relative L2 difference over all tensors): the port against the
    reference 7.3% (cosine 0.9973, loss 3.9e-3 relative); with the port's
    voxels perturbed by 1e-7 relative, seeds 1-5, 2.5-21.8% (cosine >=
    0.976, loss <= 1.9e-3); the port so perturbed against itself, seeds
    1-2, 3.9-22.9% (loss <= 5.3e-3).  So the whole step is held above
    every reading: loss within 2e-2 relative, cosine >= 0.95, relative L2
    <= 0.35, the statistics within 1e-3.  4-bit weights read 56.9%
    (cosine 0.842) and fail it; a step without fake-quant (2.2%) or
    without SmoothQuant (15.3%) passes it, and
    ``test_qat_layer_backward_matches_reference`` holds each layer at the
    float tolerances instead.  Every quantized conv's weight (sparse and
    dense) gets a finite nonzero gradient, and no quantizer state is a
    parameter."""
    variables, case_data = ref
    raw, want = case_data(case)
    model = _port(variables)
    zero_grad = biases_before_bn(model)
    assert len(zero_grad) == 11           # shared conv + 5 branches x 2 heads
    batch = load_data_to_device(raw, device="cpu")
    if case == "qat":
        port_quant.quantize_model(model, port_quant.centerpoint_recipe(),
                                  batch)
        assert not [n for n, _ in model.named_parameters()
                    if "quant" in n or "amax" in n]
    opt = build_optimizer(model.parameters(), EDict(SGD), 3)
    loss, tb = train_step(model, batch, opt, grad_clip=10.0)
    assert set(tb) == {"hm_loss_head_0", "loc_loss_head_0", "hm_loss_head_1",
                       "loc_loss_head_1"}
    loss_tol, stat_tol = (1e-5, 1e-5) if case == "float" else (2e-2, 1e-3)
    assert abs(float(loss) - want["loss"]) <= loss_tol * abs(want["loss"]), \
        (float(loss), want["loss"])

    per, rel_l2, cos = _grad_errors(model, want["grads"], zero_grad)
    top = max(scale for _, scale in per.values())
    for name in zero_grad:
        assert per[name][1] <= 1e-6 * top and \
            per[name][0] <= 2e-6 * top, (name, per[name])
    if case == "float":
        for name, (err, scale) in per.items():
            if name not in zero_grad:
                assert err <= 1e-4 * scale, (name, err, scale)
    else:
        assert cos >= 0.95 and rel_l2 <= 0.35, (cos, rel_l2)
        quantized = [m for m in model.modules()
                     if getattr(m, "rule", None) is not None
                     and getattr(m, "weight", None) is not None]
        assert sum(m.weight.dim() == 3 for m in quantized) == 20
        for m in quantized:
            assert torch.isfinite(m.weight.grad).all() \
                and float(m.weight.grad.abs().max()) > 0

    stats = state_dict_from_jax({"batch_stats": want["batch_stats"]})
    buffers = dict(model.named_buffers())
    for name, s in stats.items():
        err = float((buffers[name] - s).abs().max())
        assert err <= stat_tol * max(1.0, float(s.abs().max())), (name, err)

    if case == "float":
        # two more steps of the sgd branch (momentum 0.9, weight decay, both
        # clips): losses within 1e-4 relative, and falling
        losses = [float(loss)] + [
            float(train_step(model, batch, opt, grad_clip=10.0)[0])
            for _ in range(2)]
        for mine, w in zip(losses, want["losses"]):
            assert abs(mine - w) <= 1e-4 * abs(w), (losses, want["losses"])
        assert losses[2] < losses[0]


def _sparse_layer(jrule, rng):
    """A SubMConv3d (16 -> 32, 3^3) on a batch-2 sparse tensor with pad
    rows -> (the reference's function of (features, weight), those inputs,
    the port's module, its arguments and output as functions of the
    features, the weight gradient in the reference's layout)."""
    st, _ = _sorted_sparse(rng, 2, (4, 10, 16), 300, 16, 384)
    st = st.replace(features=st.features * 3.0)
    jmod = jax_spmodules.SubMConv3d(32, 3, 1, 1, indice_key="k")
    with quant_rules_scope(jrule):
        v = jmod.init(jax.random.PRNGKey(1), st, {})
    w = v["params"]["weight"]

    def ref_fn(x, wt):
        with quant_rules_scope(jrule):
            return jmod.apply({**v, "params": {"weight": wt}},
                              st.replace(features=x), {}).features
    mod = SubMConv3d(16, 32, 3, 1, 1, indice_key="k")
    mod.weight.data = torch.from_numpy(np.array(w))

    def args(x):
        return SparseConvTensor(
            features=x, indices=torch.from_numpy(np.array(st.indices)),
            spatial_shape=tuple(st.spatial_shape), batch_size=2,
            sorted_rows=True), {}
    return ref_fn, (st.features, w), mod, args, lambda y: y.features, \
        lambda g: g


def _dense_layer(jrule, rng):
    """A 3x3 stride-2 Conv2d (24 -> 40, bias) on post-ReLU maps (NHWC in
    the reference, NCHW in the port)."""
    x = (np.maximum(rng.randn(2, 21, 19, 24), 0) * 2.0).astype(np.float32)
    jmod = jax_layers.Conv2d(40, 3, 2, 1, bias_init=0.3)
    with quant_rules_scope(jrule):
        v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    w = v["params"]["kernel"]

    def ref_fn(xx, wt):
        with quant_rules_scope(jrule):
            return jmod.apply({**v, "params": {**v["params"], "kernel": wt}},
                              xx)
    mod = Conv2d(24, 40, 3, 2, 1)
    mod.weight.data = torch.from_numpy(
        np.array(w).transpose(3, 2, 0, 1).copy())
    mod.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))

    return ref_fn, (jnp.asarray(x), w), mod, \
        lambda xx: (xx.permute(0, 3, 1, 2),), \
        lambda y: y.permute(0, 2, 3, 1), lambda g: g.permute(2, 3, 1, 0)


@functools.partial(jax.jit, static_argnums=2)
def _jitted_sq_scale(a, w, alpha):
    return jnp.maximum(jnp.power(a, alpha) / jnp.power(w, 1.0 - alpha), 1e-5)


def _reference_sq_scale(a_amax, w_amax, alpha):
    """The reference's SmoothQuant column scale (XLA's jitted ``pow``),
    as a tensor without gradient; compiled once per shape and alpha."""
    scale = _jitted_sq_scale(a_amax.detach().numpy(),
                             w_amax.detach().numpy(), alpha)
    return torch.from_numpy(np.array(scale))


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_qat_layer_backward_matches_reference(kind, monkeypatch):
    """QAT, one layer at a time, with ``centerpoint_recipe()``'s rule for it
    (sparse: per-output-channel weights, per-input-channel dynamic acts;
    dense: dynamic SmoothQuant, alpha 0.5): the port's layer fed the same
    inputs and output gradient as the reference's flax module takes the
    same rounding decisions, so its output and the straight-through input
    and weight gradients agree within 1e-5 of each tensor's largest value
    (the f32 sums run in another order).  The dense layer takes the
    reference's SmoothQuant column scale: XLA's jitted ``pow`` rounds some
    of them an ulp away from PyTorch's, and an ulp can move an activation
    across a rounding boundary (``test_torch_port_fakequant.py``).  The
    float layer is more than 100x that away from the reference's QAT
    layer, so a missing fake-quant shows; no quantizer state is a
    parameter."""
    if kind == "dense":
        monkeypatch.setattr(port_tensor_quant, "smoothquant_scale",
                            _reference_sq_scale)
    rng = np.random.RandomState(11 if kind == "sparse" else 13)
    index = 0 if kind == "sparse" else 1
    rule = port_quant.centerpoint_recipe().rules[index]
    jrule = JaxQuantRules(rules=(jax_quant.centerpoint_recipe().rules[index],))
    ref_fn, (x, w), mod, args, out_of, weight_to_ref = (
        _sparse_layer if kind == "sparse" else _dense_layer)(jrule, rng)
    out, vjp = jax.vjp(jax.jit(ref_fn), x, w)
    cot = rng.normal(0, 1, out.shape).astype(np.float32)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]

    def port(quantized):
        xt = torch.tensor(np.array(x), requires_grad=True)
        mod.rule = None
        mod.weight.grad = None
        if quantized:
            _calibrate_layer(mod, rule, [args(xt.detach())])
        y = out_of(mod(*args(xt)))
        (y * torch.from_numpy(cot)).sum().backward()
        return [y.detach().numpy(), xt.grad.numpy(),
                weight_to_ref(mod.weight.grad).numpy()]

    float_got = port(False)
    got = port(True)
    assert not [n for n, _ in mod.named_parameters() if n != "weight"
                and n != "bias"]
    for name, g, r, f in zip(("out", "dX", "dW"), got, want, float_got):
        scale = np.abs(r).max()
        assert g.shape == r.shape and scale > 0, name
        err = np.abs(g - r).max()
        assert err <= 1e-5 * scale, (kind, name, err / scale)
        assert np.abs(f - r).max() > 1e-3 * scale, (kind, name)


def test_train_cli_one_epoch_then_resume(tmp_path):
    """``python -m q3d_tpu_torch.tools.train`` on the CPU, 4 frames at batch
    2: one epoch writes checkpoint_epoch_1.pth (pcdet's layout, read back
    by the .pth import); asked for the same epoch again, the run resumes
    from that checkpoint and has no step left to take."""
    import shutil
    from q3d_tpu_torch.tools import train as train_cli
    from q3d_tpu_torch.utils.checkpoint import load_pth_file
    tag = f"test_{tmp_path.name}"
    run_dir = ROOT / "output" / "cfgs" / "synthetic_models" / \
        "centerpoint_tiny" / tag
    args = ["--cfg_file", str(CFG_DIR / "centerpoint_tiny.yaml"),
            "--extra_tag", tag, "--device", "cpu", "--fix_random_seed",
            "--epochs", "1", "--set", "DATA_CONFIG.NUM_FRAMES", "4"]
    try:
        ckpt_dir, hist = train_cli.main(args)
        assert ckpt_dir == run_dir / "ckpt"
        assert [h["it"] for h in hist] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in hist)
        first = ckpt_dir / "checkpoint_epoch_1.pth"
        assert sorted(p.name for p in ckpt_dir.iterdir()) == [first.name]
        state = load_pth_file(first)
        assert "backbone_3d.conv_input.0.weight" in state
        _, hist2 = train_cli.main(args)
        assert hist2 == []
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        for d in run_dir.parents:              # the empty directories above
            if d == ROOT / "output" or not d.is_dir() or any(d.iterdir()):
                break
            d.rmdir()
