"""Post-training quantization for the int8 deploy path (port of the deploy
part of ``q3d_tpu/quant/``)."""

from .api import (collect_stats, compute_amax, int8_deploy_recipe,  # noqa: F401
                  prepare_int8_deploy, quantize_model)
from .rules import LayerRule, QuantRules, SmoothQuantCfg  # noqa: F401
from .tensor_quant import QuantSpec, TensorQuantizer  # noqa: F401
