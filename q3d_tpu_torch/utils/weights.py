"""Carry the reference's weights across: JAX variables -> the port's state dict.

The port's own copy of the naming rules of ``q3d_tpu/utils/pcdet_names.py``
(flax path <-> pcdet state-dict name).  ``state_dict_from_jax`` takes the
reference's variables as nested dicts of numpy arrays
(``flax.core.unfreeze(jax.device_get(variables))``) and returns pcdet-named
tensors in the port's layouts:

  * dense conv (kh, kw, I, O) -> OIHW; transposed conv (kh, kw, O, I) -> IOHW;
  * linear (I, O) -> (O, I); TransFusion's Conv1d (k, I, O) -> torch's
    (O, I, k);
  * sparse conv (K, I, O) stays (K, Cin, Cout), K k0-major (3D and
    VoxelNeXt's 2D convs alike; VoxelNeXt's ``backbone_3d.shared_conv`` is
    (conv, BN) like ``conv_out``, apart from the CenterHead's
    ``dense_head.shared_conv``);
  * BN scale/bias/mean/var (a ``MaskedBatchNorm``'s too) and LayerNorm
    scale/bias -> weight/bias/running_mean/running_var;
  * the dynamic VFEs' ``pfn_linear_<i>`` / ``pfn_norm_<i>`` ->
    OpenPCDet's ``pfn_layers.<i>.linear / .norm``; the pillar backbones'
    ``conv<s>_<i>`` blocks -> ``conv<s>.<i>`` (as the 3D backbones'),
    their dense conv5 too; BaseBEVBackboneV1's blocks and deblocks as
    BaseBEVBackbone's; BaseBEVResBackbone's ``blocks_<i>.conv<k>[ab]`` keep
    the reference's names (OpenPCDet's BasicBlock tree differs);
  * the ``quant`` collection's amax leaves -> the quantizer buffers of an
    int8 model (``quant.api``): a conv's ``act_quant`` / ``weight_quant``
    stay on the conv, a block's ``out_quant{i}`` goes to the conv ``conv{i}``
    it requantizes, ``shared_requant/quant`` to the head's DenseRequant,
    a static SmoothQuant conv's ``sq_act_amax`` to that conv.

AnchorHeadMulti's towers keep the reference's names,
``dense_head.heads.<g>.{conv<i>, norm<i>, conv_cls, conv_box, conv_dir}``
(the reference's ``pcdet_names.py`` has no rule for this head, so the
``.pth`` import has none either); its shared conv and BN are
``shared_conv.0 / .1``, as CenterHead's.

TransFusion's head takes OpenPCDet's ``TransFusionHead`` names (the
reference's ``pcdet_names.py`` has no rules for it): ``shared_conv`` (a bare
conv there, CenterHead's ``shared_conv.0`` otherwise), ``heatmap_head.0.conv
/ .bn``, ``heatmap_head.1``, ``class_encoding``, ``decoder.<attention>.
{q,k,v,out}_proj`` (the reference's separate projections, not torch's packed
``in_proj``), ``decoder.{linear1,linear2,norm1-3}``, ``decoder.<self or
cross>_posembed.position_embedding_head.{0,1,3}`` and
``prediction_head.<branch>.{k}.0 / .1``, ``prediction_head.<branch>.<hidden
count>``.

``model.load_state_dict(state_dict_from_jax(v), strict=True)`` loads them.
``reference_module_path`` is the inverse for the quantizable modules: the
reference's dotted path, by which quantization rules match.
"""

import re

import numpy as np
import torch

# leaf-name translation: reference -> torch
_LEAF = {"kernel": "weight", "weight": "weight", "bias": "bias",
         "scale": "weight", "mean": "running_mean", "var": "running_var"}


def _module_rules(module, toks, transfusion=False, res_bev=False):
    """toks: reference module-path tokens (bn dropped) inside ``module`` ->
    the pcdet module path, ("OUT", head, branch) for a SeparateHead output
    conv (head None: TransFusion's prediction head), or None.
    ``transfusion``: the head is TransFusion's, whose shared_conv is a bare
    conv; ``res_bev``: the 2D backbone is ``BaseBEVResBackbone``, whose
    blocks keep the reference's module names."""
    t = ".".join(toks)
    if module == "vfe":
        m = re.fullmatch(r"pfn_layers_(\d+)\.(linear|norm)", t)
        if m:                                   # PillarVFE
            return f"pfn_layers.{m.group(1)}.{m.group(2)}"
        m = re.fullmatch(r"pfn_(linear|norm)_(\d+)", t)   # the dynamic VFEs
        return f"pfn_layers.{m.group(2)}.{m.group(1)}" if m else None
    if module == "backbone_3d":
        for pat, fmt in ((r"(conv_input|conv_out|shared_conv)\.conv", "{0}.0"),
                         (r"(conv_input|conv_out|shared_conv)\.norm", "{0}.1"),
                         (r"conv(\d)_(\d+)\.conv", "conv{0}.{1}.0"),
                         (r"conv(\d)_(\d+)\.norm", "conv{0}.{1}.1"),
                         (r"conv(\d)_(\d+)\.(conv1|conv2|bn1|bn2)", "conv{0}.{1}.{2}")):
            m = re.fullmatch(pat, t)
            if m:
                return fmt.format(*m.groups())
        return None
    if module == "backbone_2d":
        m = re.fullmatch(r"blocks_(\d+)\.((?:conv|norm)\d+[ab]?)", t)
        if m and res_bev:
            return f"blocks.{m.group(1)}.{m.group(2)}"
        m = re.fullmatch(r"blocks_(\d+)\.conv(\d+)", t)
        if m:
            return f"blocks.{m.group(1)}.{1 + 3 * int(m.group(2))}"
        m = re.fullmatch(r"blocks_(\d+)\.norm(\d+)", t)
        if m:
            return f"blocks.{m.group(1)}.{2 + 3 * int(m.group(2))}"
        m = re.fullmatch(r"deblocks_(\d+)\.(deconv|conv)", t)
        if m:
            return f"deblocks.{m.group(1)}.0"
        m = re.fullmatch(r"deblocks_(\d+)\.norm", t)
        if m:
            return f"deblocks.{m.group(1)}.1"
        return None
    if module == "dense_head":
        if t in ("conv_cls", "conv_box", "conv_dir_cls"):   # AnchorHeadSingle
            return t
        if t == "shared_conv":
            return "shared_conv" if transfusion else "shared_conv.0"
        r = _transfusion_rules(t)
        if r is not None:
            return r
        if t == "shared_requant":
            return "shared_requant"
        if t == "shared_norm":
            return "shared_conv.1"
        m = re.fullmatch(r"heads_(\d+)\.(conv\d+|norm\d+|conv_cls|conv_box"
                         r"|conv_dir)", t)                  # AnchorHeadMulti
        if m:
            return f"heads.{m.group(1)}.{m.group(2)}"
        m = re.fullmatch(r"heads_list_(\d+)\.([a-z_]+?)_(\d+)", t)
        if m:
            return f"heads_list.{m.group(1)}.{m.group(2)}.{m.group(3)}.0"
        m = re.fullmatch(r"heads_list_(\d+)\.([a-z_]+?)_(\d+)_norm", t)
        if m:
            return f"heads_list.{m.group(1)}.{m.group(2)}.{m.group(3)}.1"
        m = re.fullmatch(r"heads_list_(\d+)\.([a-z_]+?)_out", t)
        if m:
            return ("OUT", m.group(1), m.group(2))
        return None
    return None


def _transfusion_rules(t):
    """TransFusionHead's modules but its shared_conv (see the module
    docstring), or None."""
    fixed = {"heatmap_head_conv": "heatmap_head.0.conv",
             "heatmap_head_norm": "heatmap_head.0.bn",
             "heatmap_head_out": "heatmap_head.1",
             "class_encoding": "class_encoding"}
    if t in fixed:
        return fixed[t]
    if re.fullmatch(r"decoder\.(self_attn|multihead_attn)\.(?:[qkv]|out)_proj"
                    r"|decoder\.(linear[12]|norm[123])", t):
        return t
    m = re.fullmatch(r"decoder\.(self|cross)_posembed\.(conv0|norm|conv1)", t)
    if m:
        slot = {"conv0": 0, "norm": 1, "conv1": 3}[m.group(2)]
        return f"decoder.{m.group(1)}_posembed.position_embedding_head.{slot}"
    m = re.fullmatch(r"prediction_head\.([a-z_]+?)_(\d+)(_norm)?", t)
    if m:
        return (f"prediction_head.{m.group(1)}.{m.group(2)}."
                f"{1 if m.group(3) else 0}")
    m = re.fullmatch(r"prediction_head\.([a-z_]+?)_out", t)
    if m:
        return ("OUT", None, m.group(1))
    return None


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


class _Layout:
    """What the reference's names leave open, read off its whole tree: a
    branch's output-conv index, ``self(head, branch)`` = the branch's
    hidden-conv count (its position in pcdet's nn.Sequential; head None for
    TransFusion's prediction head), whether the head is TransFusion's (it
    has a ``decoder``), and whether the 2D backbone is BaseBEVResBackbone
    (its blocks have residual pairs ``conv<k>a / conv<k>b``)."""

    def __init__(self, flat_paths):
        self.counts, self.transfusion, self.res_bev = {}, False, False
        for path in flat_paths:
            self.res_bev |= len(path) > 3 and path[1] == "backbone_2d" \
                and re.fullmatch(r"conv\d+[ab]", path[3]) is not None
            if len(path) < 4 or path[1] != "dense_head":
                continue
            self.transfusion |= path[2] == "decoder"
            mh = re.fullmatch(r"heads_list_(\d+)|prediction_head", path[2])
            mb = re.fullmatch(r"([a-z_]+?)_(\d+)", path[3])
            if mh and mb and path[-1] in ("kernel", "weight"):
                key = (mh.group(1), mb.group(1))
                self.counts[key] = max(self.counts.get(key, 0),
                                       int(mb.group(2)) + 1)

    def __call__(self, head, branch):
        return self.counts.get((head, branch), 1)


def pcdet_name(path, out_index):
    """Reference variable path (collection, module, ..., leaf) -> pcdet
    state-dict key, or None when no rule covers it."""
    if len(path) < 3:
        return None
    coll, module, *mod_toks, leaf = path
    if coll == "quant":
        return _quant_name(module, mod_toks, leaf, out_index)
    if coll not in ("params", "batch_stats") or leaf not in _LEAF:
        return None
    r = _port_module(module, [t for t in mod_toks if t != "bn"], out_index)
    return None if r is None else f"{module}.{r}.{_LEAF[leaf]}"


def _port_module(module, toks, out_index):
    """``_module_rules`` with a branch's output conv resolved to its slot
    (``out_index``: a ``_Layout``, or any (head, branch) -> index)."""
    r = _module_rules(module, toks, getattr(out_index, "transfusion", False),
                      getattr(out_index, "res_bev", False))
    if isinstance(r, tuple):
        _, head, branch = r
        r = (f"heads_list.{head}.{branch}" if head is not None
             else f"prediction_head.{branch}") + f".{out_index(head, branch)}"
    return r


def _quant_name(module, mod_toks, leaf, out_index):
    """quant/<module>/.../<quantizer>/amax, or a static SmoothQuant conv's
    quant/<module>/.../<conv>/sq_act_amax -> the port's buffer name."""
    if leaf == "sq_act_amax" and mod_toks:
        r = _port_module(module, mod_toks, out_index)
        return None if r is None else f"{module}.{r}.sq_act_amax"
    if leaf != "amax" or not mod_toks:
        return None
    *toks, qname = mod_toks
    m = re.fullmatch(r"out_quant(\d*)", qname)
    if m:                    # a block's requant: owned by the conv it follows
        toks, qname = toks + [f"conv{m.group(1)}"], "out_quant"
    elif qname not in ("act_quant", "weight_quant", "quant"):
        return None
    r = _port_module(module, toks, out_index)
    return None if r is None else f"{module}.{r}.{qname}.amax"


# port module path -> reference module path (the quantizable modules)
_REFERENCE_PATHS = (
    (r"vfe\.pfn_layers\.(\d+)\.linear", "vfe.pfn_layers_{0}.linear"),
    (r"dense_head\.(conv_cls|conv_box|conv_dir_cls)", "dense_head.{0}"),
    (r"dense_head\.heads\.(\d+)\.(conv\d+|conv_cls|conv_box|conv_dir)",
     "dense_head.heads_{0}.{1}"),
    (r"backbone_3d\.(conv_input|conv_out|shared_conv)\.0",
     "backbone_3d.{0}.conv"),
    (r"backbone_3d\.conv(\d)\.(\d+)\.0", "backbone_3d.conv{0}_{1}.conv"),
    (r"backbone_3d\.conv(\d)\.(\d+)\.(conv1|conv2)",
     "backbone_3d.conv{0}_{1}.{2}"),
    (r"dense_head\.shared_conv\.0", "dense_head.shared_conv"),
    (r"dense_head\.shared_requant", "dense_head.shared_requant"),
    (r"dense_head\.heads_list\.(\d+)\.([a-z_]+)\.(\d+)\.0",
     "dense_head.heads_list_{0}.{1}_{2}"),
    (r"dense_head\.heads_list\.(\d+)\.([a-z_]+)\.\d+",
     "dense_head.heads_list_{0}.{1}_out"),
    # TransFusionHead
    (r"dense_head\.shared_conv", "dense_head.shared_conv"),
    (r"dense_head\.heatmap_head\.0\.conv", "dense_head.heatmap_head_conv"),
    (r"dense_head\.heatmap_head\.1", "dense_head.heatmap_head_out"),
    (r"dense_head\.class_encoding", "dense_head.class_encoding"),
    (r"dense_head\.decoder\.(self_attn|multihead_attn)\.((?:[qkv]|out)_proj)",
     "dense_head.decoder.{0}.{1}"),
    (r"dense_head\.decoder\.(linear[12])", "dense_head.decoder.{0}"),
    (r"dense_head\.decoder\.(self|cross)_posembed\.position_embedding_head"
     r"\.0", "dense_head.decoder.{0}_posembed.conv0"),
    (r"dense_head\.decoder\.(self|cross)_posembed\.position_embedding_head"
     r"\.3", "dense_head.decoder.{0}_posembed.conv1"),
    (r"dense_head\.prediction_head\.([a-z_]+)\.(\d+)\.0",
     "dense_head.prediction_head.{0}_{1}"),
    (r"dense_head\.prediction_head\.([a-z_]+)\.\d+",
     "dense_head.prediction_head.{0}_out"),
)

# TransFusion's Conv1d weights (torch's (O, I, k); the reference's (k, I, O))
_CONV1D_WEIGHT = re.compile(
    r"dense_head\.(class_encoding|decoder\.\w+_posembed\."
    r"position_embedding_head\.[03]|prediction_head\.[a-z_]+\.\d+(\.0)?)"
    r"\.weight")


def reference_module_path(name, module=None):
    """Port module name -> the reference's dotted module path (inverse of
    ``_module_rules`` for convs and the head's DenseRequant), or None.  A
    deblock's slot 0 is the reference's ``deconv``, or its ``conv`` when
    ``module`` is a (1x1) Conv2d (``USE_CONV_FOR_NO_STRIDE``); a PFN
    linear is ``pfn_linear_<i>`` when ``module`` is a dynamic VFE's."""
    m = re.fullmatch(r"backbone_2d\.blocks\.(\d+)\.(\d+)", name)
    if m and (int(m.group(2)) - 1) % 3 == 0:
        return f"backbone_2d.blocks_{m.group(1)}.conv{(int(m.group(2)) - 1) // 3}"
    m = re.fullmatch(r"backbone_2d\.blocks\.(\d+)\.(conv\d+[ab]?)", name)
    if m:                                       # BaseBEVResBackbone
        return f"backbone_2d.blocks_{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"vfe\.pfn_layers\.(\d+)\.linear", name)
    if m and getattr(module, "dynamic_pfn", False):
        return f"vfe.pfn_linear_{m.group(1)}"
    m = re.fullmatch(r"backbone_2d\.deblocks\.(\d+)\.0", name)
    if m:
        kind = getattr(module, "QUANT_KIND", "conv_transpose2d")
        return f"backbone_2d.deblocks_{m.group(1)}." \
            f"{'conv' if kind == 'conv2d' else 'deconv'}"
    for pat, fmt in _REFERENCE_PATHS:
        m = re.fullmatch(pat, name)
        if m:
            return fmt.format(*m.groups())
    return None


def to_port_layout(arr, key):
    """Reference array -> the port's layout for the port's state-dict
    ``key`` (see the module docstring)."""
    a = np.asarray(arr)
    torch_leaf = key.rsplit(".", 1)[1]
    if _CONV1D_WEIGHT.fullmatch(key):
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    if torch_leaf == "weight" and a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if torch_leaf == "weight" and a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(a)


def state_dict_from_jax(variables):
    """Reference variables (nested dicts of numpy arrays; ``params``,
    ``batch_stats`` and optionally ``quant``) -> {pcdet name: tensor} in the
    port's layouts.  Raises on a leaf with no naming rule."""
    flat = _flatten(variables)
    out_index = _Layout(list(flat))
    state = {}
    for path, leaf in flat.items():
        key = pcdet_name(path, out_index)
        if key is None:
            raise KeyError(f"no port name for reference variable "
                           f"{'/'.join(path)}")
        state[key] = torch.tensor(to_port_layout(leaf, key))
    return state
