"""The PTQ workflow (port of ``q3d_tpu/quant/api.py``: the CenterPoint,
SECOND, PointPillars, VoxelNeXt and TransFusion fake-quant recipes, the int8
deploy recipe (dynamic, static, SmoothQuant, residency), ``quantize_model``,
single-stream ``collect_stats``, ``compute_amax`` with the reference's amax
methods, and ``prepare_int8_deploy``).

    quantize_model(model, centerpoint_recipe(sq=True), batch)  # dynamic PTQ
    quantize_model(model, centerpoint_recipe(sq=False, static=True), batch)
    collect_stats(model, batches)                              # static PTQ
    compute_amax(model, method="entropy")
    out = model(batch)                      # quantized from here on

    quantize_model(model, int8_deploy_recipe(sq=True), batch)  # true int8
    rules = prepare_int8_deploy(model, [batch, batch])   # int8 residency

In PyTorch idiom the model is changed in place: ``quantize_model`` resolves
each quantizable layer's rule once, by its path in the reference's naming
(``utils.weights.reference_module_path``), and attaches it; quantizers are
created on first use in a calibration pass, as the reference creates its
quantizer variables in ``model.init``; ``model.state_dict()`` then carries
every committed amax (and each static SmoothQuant layer's
``sq_act_amax``: dense or sparse conv, Linear, transposed conv).  Not
ported: sharded calibration.  ``_check_rule`` raises where the reference
has no int8 path: a SmoothQuant rule on an int8 sparse conv, and any int8
deploy rule on a Linear, Conv1d or transposed conv.

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


def second_recipe(w_bits=8, act_bits=8, sq=True, alpha=0.5, static=False):
    """The reference's ``quant_second.py`` semantics: CenterPoint's rules,
    with AnchorHeadSingle's three output convs left float."""
    base = centerpoint_recipe(w_bits, act_bits, sq, alpha, static)
    no_list = (
        "backbone_3d.conv_input*",
        "dense_head.conv_cls", "dense_head.conv_box", "dense_head.conv_dir_cls",
    )
    return QuantRules(rules=base.rules, no_list=no_list)


def pointpillar_recipe(w_bits=8, act_bits=8, sq=True, alpha=0.5,
                       static=False):
    """The reference's ``quant_pointpillar.py`` semantics: CenterPoint's
    rules, with the pillar VFE and AnchorHeadSingle's output convs left
    float."""
    base = centerpoint_recipe(w_bits, act_bits, sq, alpha, static)
    no_list = (
        "vfe*",
        "dense_head.conv_cls", "dense_head.conv_box", "dense_head.conv_dir_cls",
    )
    return QuantRules(rules=base.rules, no_list=no_list)


def int8_deploy_recipe(sq=False, alpha=0.5, static=False, extra_no_list=(),
                       residency=False, quantize_first_conv=False):
    """True-int8 execution for every backbone conv (sparse 3D + dense 2D):
    per-tensor act scales (dynamic, or calibrated when ``static``),
    per-out-channel weight scales, int8 GEMMs with int32 accumulation.
    Heads + first sparse conv stay FP unless ``quantize_first_conv``.

    ``sq``: the dense convs migrate scale per im2col column first
    (SmoothQuant, its column amax taken from each batch).
    ``residency`` (implies static): features stay int8 from conv to conv,
    with BN/ReLU/requant folded into the conv epilogues; the dense convs
    keep it only without ``sq``.  A static recipe needs calibration first
    (quantize_model -> collect_stats -> compute_amax)."""
    static = static or residency
    calib = "histogram" if static else "max"
    act = QuantSpec(8, axis=None, dynamic=not static, calibrator=calib)
    weight = QuantSpec(8, axis=0, dynamic=True)
    sparse_rule = LayerRule(
        layer_kinds=("subm_conv3d", "sparse_conv3d", "subm_conv2d",
                     "sparse_conv2d"),
        weight=weight, act=act, deploy_int8=True, int8_residency=residency)
    conv2d_rule = LayerRule(
        layer_kinds=("conv2d",), weight=weight, act=act,
        smoothquant=SmoothQuantCfg(alpha=alpha, dynamic=True) if sq else None,
        deploy_int8=True, int8_residency=residency and not sq)
    no_list = (
        "dense_head.heads_list_*.*_out",
        "dense_head.heads_list_*.hm_*",
        "dense_head.conv_cls", "dense_head.conv_box", "dense_head.conv_dir_cls",
    ) + tuple(extra_no_list)
    if not quantize_first_conv:
        no_list = ("backbone_3d.conv_input*",) + no_list
    return QuantRules(rules=(sparse_rule, conv2d_rule), no_list=no_list)


def voxelnext_recipe(w_bits=8, act_bits=8, sq=True, alpha=0.5,
                     static=False):
    """The reference's ``quant_voxelnext.py`` semantics: the 3D backbone's
    convs as in ``centerpoint_recipe``; the sparse 2D convs (conv_out,
    shared_conv, the heads' hidden convs) through the gather-view
    SmoothQuant (``SQSubM2d``), or plain fake-quant when not ``sq``; per
    head every branch's output conv and both hm convs stay float."""
    dynamic = not static
    calib = "histogram" if static else "max"
    sparse3d = LayerRule(
        layer_kinds=("subm_conv3d", "sparse_conv3d"),
        weight=QuantSpec(w_bits, axis=0, dynamic=True),
        act=QuantSpec(act_bits, axis=1 if sq else None, dynamic=dynamic,
                      calibrator="max" if sq else calib),
    )
    sparse2d = LayerRule(
        layer_kinds=("subm_conv2d", "sparse_conv2d"),
        weight=QuantSpec(w_bits, axis=0, dynamic=True),
        act=QuantSpec(act_bits, axis=None, dynamic=dynamic, calibrator=calib),
        smoothquant=SmoothQuantCfg(alpha=alpha, dynamic=dynamic) if sq else None,
    )
    no_list = (
        "backbone_3d.conv_input*",
        "dense_head.heads_list_*.*_out",
        "dense_head.heads_list_*.hm_*",
    )
    return QuantRules(rules=(sparse3d, sparse2d), no_list=no_list)


def transfusion_recipe(w_bits=8, act_bits=8, sq=True, alpha=0.5,
                       static=False):
    """The reference's ``quant_transfusion.py`` semantics: CenterPoint's
    rules for the sparse and dense convs, plus the decoder's Linears and
    Conv1ds (``dense_head.decoder*``) through SmoothQuant (or plain
    fake-quant when not ``sq``); both attention out-projections, the
    prediction head's output convs and the heatmap's output conv stay
    float."""
    base = centerpoint_recipe(w_bits, act_bits, sq, alpha, static)
    dynamic = not static
    calib = "histogram" if static else "max"
    linear_rule = LayerRule(
        layer_kinds=("linear", "conv1d"),
        weight=QuantSpec(w_bits, axis=0, dynamic=True),
        act=QuantSpec(act_bits, axis=None, dynamic=dynamic, calibrator=calib),
        smoothquant=SmoothQuantCfg(alpha=alpha, dynamic=dynamic) if sq else None,
        pattern="dense_head.decoder*",
    )
    no_list = (
        "backbone_3d.conv_input*",
        "dense_head.decoder.self_attn.out_proj",
        "dense_head.decoder.multihead_attn.out_proj",
        "dense_head.prediction_head.*_out",
        "dense_head.heatmap_head_out",
    )
    return QuantRules(rules=base.rules + (linear_rule,), no_list=no_list)


def quantizable_modules(model):
    """(port name, module) of every layer a rule can match: the modules with
    a ``QUANT_KIND``."""
    return [(n, m) for n, m in model.named_modules() if hasattr(m, "QUANT_KIND")]


def _check_rule(rule, path, kind):
    """The rules ported: fake-quant (group quantization included;
    SmoothQuant on dense convs, Linears, Conv1ds and transposed convs and,
    over the gather view, on sparse ones) and int8 deploy (per-tensor act
    scales, dynamic or static; dynamic per-channel weight scales;
    SmoothQuant on dense convs, without residency; residency with static
    act scales) on the convs the reference runs in int8."""
    if rule is None:
        return
    if rule.deploy_int8 and kind in ("linear", "conv1d", "conv_transpose2d"):
        raise NotImplementedError(
            f"{path}: the reference has no int8 deploy path for kind "
            f"{kind!r} (its layer fake-quantizes)")
    if rule.smoothquant is not None and kind != "conv2d" \
            and rule.deploy_int8:
        raise NotImplementedError(
            f"{path}: SmoothQuant on an int8 sparse conv is not ported (the "
            f"reference's int8 deploy ignores it; ROADMAP.md)")
    if not rule.deploy_int8:
        return
    if any(spec is not None and spec.group_size
           for spec in (rule.act, rule.weight)):
        raise ValueError(f"{path}: group quantization is fake-quant only")
    if rule.act is None or rule.act.axis is not None:
        raise ValueError(f"{path}: int8 deploy needs per-tensor act scales")
    if rule.weight is None or rule.weight.axis is None \
            or not rule.weight.dynamic:
        raise ValueError(f"{path}: int8 deploy quantizes the weight per output "
                         f"channel, dynamically")
    if rule.int8_residency and (rule.act.dynamic
                                or rule.smoothquant is not None):
        raise ValueError(f"{path}: int8 residency needs static act scales and "
                         f"no SmoothQuant")


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
        path = reference_module_path(name, mod)
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
    training = model.training
    model.eval()              # a model in training keeps its BN statistics
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        model.train(training)
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
    (``int8_deploy_recipe(residency=True, **recipe_kwargs)``), calibration,
    committed amax (method "max").  ``example_batches``: device-ready batch
    dicts (one representative batch given twice is enough for max
    calibration).  Quantizes ``model`` in place and returns the rules."""
    rules = int8_deploy_recipe(residency=True, **(recipe_kwargs or {}))
    quantize_model(model, rules, example_batches[0])
    collect_stats(model, example_batches, num_batches=len(example_batches))
    compute_amax(model)
    return rules
