"""Post-training quantization (port of ``q3d_tpu/quant/``): fake-quant and
SmoothQuant recipes with static calibration, the int8 deploy path, and the
sensitivity tooling."""

from .api import (centerpoint_recipe, collect_stats,  # noqa: F401
                  compute_amax, int8_deploy_recipe, prepare_int8_deploy,
                  quantize_model)
from .rules import LayerRule, QuantRules, SmoothQuantCfg  # noqa: F401
from .tensor_quant import QuantSpec, TensorQuantizer, fake_quant  # noqa: F401
