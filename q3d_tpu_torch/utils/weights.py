"""Carry the reference's weights across: JAX variables -> the port's state dict.

The port's own copy of the naming rules of ``q3d_tpu/utils/pcdet_names.py``
(flax path <-> pcdet state-dict name).  ``state_dict_from_jax`` takes the
reference's variables as nested dicts of numpy arrays
(``flax.core.unfreeze(jax.device_get(variables))``) and returns pcdet-named
tensors in the port's layouts:

  * dense conv (kh, kw, I, O) -> OIHW; transposed conv (kh, kw, O, I) -> IOHW;
  * sparse conv (K, I, O) stays (K, Cin, Cout), K k0-major;
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * the ``quant`` collection's amax leaves -> the quantizer buffers of an
    int8 model (``quant.api``): a conv's ``act_quant`` / ``weight_quant``
    stay on the conv, a block's ``out_quant{i}`` goes to the conv ``conv{i}``
    it requantizes, ``shared_requant/quant`` to the head's DenseRequant,
    a static SmoothQuant conv's ``sq_act_amax`` to that conv.

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


def _module_rules(module, toks):
    """toks: reference module-path tokens (bn dropped) inside ``module`` ->
    the pcdet module path, ("OUT", head, branch) for a SeparateHead output
    conv, or None."""
    t = ".".join(toks)
    if module == "backbone_3d":
        for pat, fmt in ((r"conv_(input|out)\.conv", "conv_{0}.0"),
                         (r"conv_(input|out)\.norm", "conv_{0}.1"),
                         (r"conv(\d)_(\d+)\.conv", "conv{0}.{1}.0"),
                         (r"conv(\d)_(\d+)\.norm", "conv{0}.{1}.1"),
                         (r"conv(\d)_(\d+)\.(conv1|conv2|bn1|bn2)", "conv{0}.{1}.{2}")):
            m = re.fullmatch(pat, t)
            if m:
                return fmt.format(*m.groups())
        return None
    if module == "backbone_2d":
        m = re.fullmatch(r"blocks_(\d+)\.conv(\d+)", t)
        if m:
            return f"blocks.{m.group(1)}.{1 + 3 * int(m.group(2))}"
        m = re.fullmatch(r"blocks_(\d+)\.norm(\d+)", t)
        if m:
            return f"blocks.{m.group(1)}.{2 + 3 * int(m.group(2))}"
        m = re.fullmatch(r"deblocks_(\d+)\.deconv", t)
        if m:
            return f"deblocks.{m.group(1)}.0"
        m = re.fullmatch(r"deblocks_(\d+)\.norm", t)
        if m:
            return f"deblocks.{m.group(1)}.1"
        return None
    if module == "dense_head":
        if t == "shared_conv":
            return "shared_conv.0"
        if t == "shared_requant":
            return "shared_requant"
        if t == "shared_norm":
            return "shared_conv.1"
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


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _out_index(flat_paths):
    """SeparateHead output-conv index = the branch's hidden-conv count (its
    position in pcdet's nn.Sequential)."""
    counts = {}
    for path in flat_paths:
        if len(path) < 4 or path[1] != "dense_head":
            continue
        mh = re.fullmatch(r"heads_list_(\d+)", path[2])
        mb = re.fullmatch(r"([a-z_]+?)_(\d+)", path[3])
        if mh and mb and path[-1] in ("kernel", "weight"):
            key = (mh.group(1), mb.group(1))
            counts[key] = max(counts.get(key, 0), int(mb.group(2)) + 1)
    return lambda head, branch: counts.get((head, branch), 1)


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
    """``_module_rules`` with a branch's output conv resolved to its slot."""
    r = _module_rules(module, toks)
    if isinstance(r, tuple):
        _, head, branch = r
        r = f"heads_list.{head}.{branch}.{out_index(head, branch)}"
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
    (r"backbone_3d\.conv_(input|out)\.0", "backbone_3d.conv_{0}.conv"),
    (r"backbone_3d\.conv(\d)\.(\d+)\.0", "backbone_3d.conv{0}_{1}.conv"),
    (r"backbone_3d\.conv(\d)\.(\d+)\.(conv1|conv2)",
     "backbone_3d.conv{0}_{1}.{2}"),
    (r"dense_head\.shared_conv\.0", "dense_head.shared_conv"),
    (r"dense_head\.shared_requant", "dense_head.shared_requant"),
    (r"dense_head\.heads_list\.(\d+)\.([a-z_]+)\.(\d+)\.0",
     "dense_head.heads_list_{0}.{1}_{2}"),
    (r"dense_head\.heads_list\.(\d+)\.([a-z_]+)\.\d+",
     "dense_head.heads_list_{0}.{1}_out"),
)


def reference_module_path(name):
    """Port module name -> the reference's dotted module path (inverse of
    ``_module_rules`` for convs and the head's DenseRequant), or None."""
    m = re.fullmatch(r"backbone_2d\.blocks\.(\d+)\.(\d+)", name)
    if m and (int(m.group(2)) - 1) % 3 == 0:
        return f"backbone_2d.blocks_{m.group(1)}.conv{(int(m.group(2)) - 1) // 3}"
    for pat, fmt in _REFERENCE_PATHS:
        m = re.fullmatch(pat, name)
        if m:
            return fmt.format(*m.groups())
    return None


def to_port_layout(arr, torch_leaf):
    """Reference array -> the port's layout (see the module docstring)."""
    a = np.asarray(arr)
    if torch_leaf == "weight" and a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    return np.ascontiguousarray(a)


def state_dict_from_jax(variables):
    """Reference variables (nested dicts of numpy arrays; ``params``,
    ``batch_stats`` and optionally ``quant``) -> {pcdet name: tensor} in the
    port's layouts.  Raises on a leaf with no naming rule."""
    flat = _flatten(variables)
    out_index = _out_index(list(flat))
    state = {}
    for path, leaf in flat.items():
        key = pcdet_name(path, out_index)
        if key is None:
            raise KeyError(f"no port name for reference variable "
                           f"{'/'.join(path)}")
        state[key] = torch.tensor(to_port_layout(leaf, key.rsplit(".", 1)[1]))
    return state
