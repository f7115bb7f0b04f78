"""Path-matched quantization rules (port of ``q3d_tpu/quant/rules.py``).

A rule set is static data: every quantizable layer asks it "am I
quantized, and how?" with its dotted module path in the reference's
naming (``backbone_3d.conv_input.conv``, ``dense_head.heads_list_0.hm_0``),
so the reference's recipes and ``no_list`` patterns apply verbatim.  The
reference asks through a thread-local scope at trace time; here
``quant.api.quantize_model`` resolves each layer's rule once and attaches
it to the module.
"""

import dataclasses
import fnmatch
from typing import Optional, Tuple

from .tensor_quant import QuantSpec


@dataclasses.dataclass(frozen=True)
class SmoothQuantCfg:
    """SmoothQuant activation->weight scale migration:
    s = act_amax^alpha / w_amax^(1-alpha), per im2col column."""
    alpha: float = 0.5
    dynamic: bool = True


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """What to do to one layer class / path pattern."""
    layer_kinds: Tuple[str, ...]          # e.g. ('conv2d',), ('subm_conv3d','sparse_conv3d')
    weight: Optional[QuantSpec] = QuantSpec(num_bits=8, axis=0, dynamic=True)
    act: Optional[QuantSpec] = QuantSpec(num_bits=8, axis=None, dynamic=True)
    smoothquant: Optional[SmoothQuantCfg] = None
    pattern: str = "*"                     # fnmatch over the dotted path
    # True -> real int8 GEMMs (x_q @ w_q -> int32 -> rescale); needs
    # per-tensor act scales
    deploy_int8: bool = False
    # True -> features stay int8 between consecutive quantized convs, each
    # block folding BN + ReLU + requantization into the conv's epilogue;
    # needs deploy_int8 and static (calibrated) act scales
    int8_residency: bool = False


@dataclasses.dataclass(frozen=True)
class QuantRules:
    """A full quantization configuration: ordered rules + exclusion list."""
    rules: Tuple[LayerRule, ...] = ()
    no_list: Tuple[str, ...] = ()

    def lookup(self, path: str, kind: str) -> Optional[LayerRule]:
        """First matching rule for (dotted path, layer kind); None = keep FP."""
        for pattern in self.no_list:
            if path == pattern or fnmatch.fnmatch(path, pattern):
                return None
        for rule in self.rules:
            if kind in rule.layer_kinds and fnmatch.fnmatch(path, rule.pattern):
                return rule
        return None
