"""The PTQ workflow (port of ``q3d_tpu/quant/api.py``: the CenterPoint
fake-quant recipe and the int8 deploy recipe with int8 residency,
``quantize_model``, single-stream ``collect_stats``, ``compute_amax`` with
the reference's amax methods, and ``prepare_int8_deploy``).

    quantize_model(model, centerpoint_recipe(sq=True), batch)  # dynamic PTQ
    quantize_model(model, centerpoint_recipe(sq=False, static=True), batch)
    collect_stats(model, batches)                              # static PTQ
    compute_amax(model, method="entropy")
    out = model(batch)                      # quantized from here on

    rules = prepare_int8_deploy(model, [batch, batch])         # true int8

In PyTorch idiom the model is changed in place: ``quantize_model`` resolves
each quantizable layer's rule once, by its path in the reference's naming
(``utils.weights.reference_module_path``), and attaches it; quantizers are
created on first use in a calibration pass, as the reference creates its
quantizer variables in ``model.init``; ``model.state_dict()`` then carries
every committed amax (and each static SmoothQuant conv's
``sq_act_amax``).  Not ported (``_check_rule`` raises, naming
``ROADMAP.md``): int8 deploy without residency or with SmoothQuant, the
sparse gather-view SmoothQuant (VoxelNeXt), group quantization.

Like the reference, whose ``quantize_model`` calls ``model.init`` on the
example batch with the calibration state mutable, the statistics start
with one calibration pass of the example batch through the model as
initialised (random weights, identity BNs): that pass fixes the histogram's
first bin width, and so moves the committed amax by up to one bin.
"""

import copy

import torch

from .rules import LayerRule, QuantRules, SmoothQuantCfg
from .tensor_quant import QuantSpec, TensorQuantizer


def centerpoint_recipe(w_bits=8, act_bits=8, sq=True, alpha=0.5,
                       static=False, extra_no_list=()):
    """The reference's ``quant_centerpoint.py:74-131`` semantics:
    - sparse 3D convs -> per-out-channel weights + per-IN-channel acts when
      sq ('cw' flag), skipping the first conv (backbone_3d.conv_input);
    - Conv2d -> SmoothQuant(alpha) (or plain fake-quant when sq=False),
      skipping every detection-head output conv and the hm branches."""
    dynamic = not static
    calib = "histogram" if static else "max"
    sparse_rule = LayerRule(
        layer_kinds=("subm_conv3d", "sparse_conv3d"),
        weight=QuantSpec(w_bits, axis=0, dynamic=True),
        act=QuantSpec(act_bits, axis=1 if sq else None, dynamic=dynamic,
                      calibrator="max" if sq else calib),
    )
    conv2d_rule = LayerRule(
        layer_kinds=("conv2d",),
        weight=QuantSpec(w_bits, axis=0, dynamic=True),
        act=QuantSpec(act_bits, axis=None, dynamic=dynamic, calibrator=calib),
        smoothquant=SmoothQuantCfg(alpha=alpha, dynamic=dynamic) if sq else None,
    )
    no_list = (
        "backbone_3d.conv_input*",
        "dense_head.heads_list_*.*_out",   # every branch's output conv
        "dense_head.heads_list_*.hm_*",    # full-precision heatmap branch
    ) + tuple(extra_no_list)
    return QuantRules(rules=(sparse_rule, conv2d_rule), no_list=no_list)


def int8_deploy_recipe(extra_no_list=(), quantize_first_conv=False):
    """True-int8 execution with int8 residency for every backbone conv
    (sparse 3D + dense 2D): per-out-channel weight scales, int8 GEMMs with
    int32 accumulation, and features that stay int8 from conv to conv, with
    BN/ReLU/requant folded into the conv epilogues (the reference's recipe
    with ``residency=True``).  Heads + first sparse conv stay FP unless
    ``quantize_first_conv``.  Needs calibration first (collect_stats ->
    compute_amax)."""
    act = QuantSpec(8, axis=None, dynamic=False, calibrator="histogram")
    weight = QuantSpec(8, axis=0, dynamic=True)
    sparse_rule = LayerRule(
        layer_kinds=("subm_conv3d", "sparse_conv3d", "subm_conv2d",
                     "sparse_conv2d"),
        weight=weight, act=act, deploy_int8=True, int8_residency=True)
    conv2d_rule = LayerRule(layer_kinds=("conv2d",), weight=weight, act=act,
                            deploy_int8=True, int8_residency=True)
    no_list = (
        "dense_head.heads_list_*.*_out",
        "dense_head.heads_list_*.hm_*",
        "dense_head.conv_cls", "dense_head.conv_box", "dense_head.conv_dir_cls",
    ) + tuple(extra_no_list)
    if not quantize_first_conv:
        no_list = ("backbone_3d.conv_input*",) + no_list
    return QuantRules(rules=(sparse_rule, conv2d_rule), no_list=no_list)


def quantizable_modules(model):
    """(port name, module) of every layer a rule can match: the modules with
    a ``QUANT_KIND``."""
    return [(n, m) for n, m in model.named_modules() if hasattr(m, "QUANT_KIND")]


def _check_rule(rule, path, kind):
    """The rules ported: fake-quant (SmoothQuant on dense convs only) and
    int8 deploy with residency (static per-tensor act scales, dynamic
    per-channel weight scales, no SmoothQuant)."""
    if rule is None:
        return
    for spec in (rule.act, rule.weight):
        if spec is not None and spec.group_size:
            raise NotImplementedError(
                f"{path}: group quantization is not ported (ROADMAP.md)")
    if not rule.deploy_int8:
        if rule.smoothquant is not None and kind != "conv2d":
            raise NotImplementedError(
                f"{path}: the sparse gather-view SmoothQuant (VoxelNeXt) is "
                f"not ported (ROADMAP.md)")
        return
    if not rule.int8_residency or rule.smoothquant is not None:
        raise NotImplementedError(
            f"{path}: int8 deploy is ported with int8 residency and without "
            f"SmoothQuant only (ROADMAP.md)")
    if rule.act is None or rule.act.axis is not None or rule.act.dynamic:
        raise ValueError(f"{path}: int8 residency needs static per-tensor "
                         f"act scales")
    if rule.weight is None or rule.weight.axis is None \
            or not rule.weight.dynamic:
        raise ValueError(f"{path}: int8 deploy quantizes the weight per output "
                         f"channel, dynamically")


def _seed_state(model):
    """The weights of the seed calibration pass: the port's seeded init."""
    from ..models.builder import INIT_SEED
    init = copy.deepcopy(model).cpu()
    init.init_weights(torch.Generator().manual_seed(INIT_SEED))
    return init.state_dict()


def quantize_model(model, rules, example_batch):
    """Attach each quantizable layer's rule (None = stays float), make every
    BN return f32 as the reference's do (flax promotes a bf16 input with
    its f32 parameters), and run the seed calibration pass of
    ``example_batch`` through the model as initialised.  Changes ``model``
    in place and returns it."""
    from ..models.layers import BatchNorm
    from ..ops.spconv.modules import SparseBatchNorm
    from ..utils.weights import reference_module_path

    for name, mod in quantizable_modules(model):
        path = reference_module_path(name)
        if path is None:
            raise KeyError(f"no reference path for quantizable module {name}")
        rule = rules.lookup(path, mod.QUANT_KIND)
        _check_rule(rule, path, mod.QUANT_KIND)
        mod.rule = rule
    for mod in model.modules():
        if isinstance(mod, (BatchNorm, SparseBatchNorm)):
            mod.out_f32 = True

    float_state = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(_seed_state(model), strict=True)
    _calibration_pass(model, example_batch, eager=True)
    res = model.load_state_dict(float_state, strict=False)
    if res.unexpected_keys or any(not k.endswith("amax")
                                  for k in res.missing_keys):
        raise RuntimeError(f"restoring the float weights: {res}")
    return model


def _calibration_pass(model, batch, eager=False):
    """One forward with every quantizer recording (``eager``: rounding as
    the reference's un-jitted ``model.init`` does)."""
    mods = [m for _, m in quantizable_modules(model)]
    for m in mods:
        m.calibrating, m.eager = True, eager
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for m in mods:
            m.calibrating, m.eager = False, False


def collect_stats(model, batches, num_batches=200):
    """Run calibration batches (the reference's single-stream
    ``collect_stats``): every quantizer records its inputs.  Fake-quant
    layers pass their inputs through unquantized; int8 layers quantize with
    each batch's own amax, so a layer's statistics are taken on the int8
    output of the layers before it."""
    for i, batch in enumerate(batches):
        if i >= num_batches:
            break
        _calibration_pass(model, batch)
    return model


def compute_amax(model, method="max", **kwargs):
    """Commit every quantizer's amax from its calibration state (the
    reference's ``compute_amax`` / ``resolve_amax``): a histogram quantizer
    by ``method`` ("max", "percentile", "mse" or "entropy"; ``kwargs`` go
    to ``calib.compute_amax_from_hist``), a max-only one by its running
    absmax, and each static SmoothQuant conv's per-column ``sq_act_amax``
    by its running ``sq_act_absmax``."""
    for mod in model.modules():
        if isinstance(mod, TensorQuantizer):
            mod.commit_amax(method, **kwargs)
        elif "sq_act_absmax" in getattr(mod, "_buffers", {}):
            mod.sq_act_amax.copy_(mod.sq_act_absmax)
    return model


def prepare_int8_deploy(model, example_batches, recipe_kwargs=None):
    """One-call int8 deployment prep: the residency recipe
    (``recipe_kwargs`` for ``int8_deploy_recipe``), calibration, committed
    amax.  ``example_batches``: device-ready batch dicts (one representative
    batch given twice is enough for max calibration).  Quantizes ``model``
    in place and returns the rules."""
    rules = int8_deploy_recipe(**(recipe_kwargs or {}))
    quantize_model(model, rules, example_batches[0])
    collect_stats(model, example_batches, num_batches=len(example_batches))
    compute_amax(model)
    return rules
