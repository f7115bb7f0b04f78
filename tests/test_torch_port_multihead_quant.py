"""PyTorch port vs the JAX package: SECOND-MultiHead's three quant forms,
layer by layer, on the small model that ``torch_port_multihead_common``
makes from the Lyft yaml (f32, batch 2, BN statistics calibrated).

The reference's recipes are copied as written: their no_lists name
AnchorHeadSingle's ``dense_head.conv_cls / conv_box / conv_dir_cls``, so
every conv of AnchorHeadMulti's towers is quantized, the output convs
included (``ROADMAP.md`` §3, a reading to settle).

* ``second_recipe()`` (dynamic SmoothQuant fake-quant): each conv fed the
  reference's own input, within 2e-6 of its output's largest magnitude
  (sparse and float convs) or 2e-3 (the SmoothQuant dense convs: XLA's
  jitted ``pow`` rounds some column scales an ulp away), as SECOND's;
* ``int8_deploy_recipe()`` (dynamic int8 without residency): each conv fed
  the reference's input within 1e-6 (the int8 operands equal, the rescale
  in another association);
* the residency deploy (``prepare_int8_deploy``: kernel 1's fused s8
  entry, method "max" on the batch, both sides seeded on the
  reference's initial weights): one quantizer per reference amax leaf and
  every weight amax equal.  The activation amax are calibrated through
  each package's own int8 chain, where a flipped rounding spreads (the
  last BEV block's output amax 1.6e-2 apart, measured; random weights,
  ``ROADMAP.md`` §3 "Traps"), so the layers are held on the reference's
  amax, loaded: every residency layer's int8 output equal to the
  reference's but at <= 1e-3 of its elements, each off by exactly 1, and
  the head's convs (a residency conv hands back its raw f32 for the float
  BN after it) fed the reference's input within 1e-6.
"""

import copy
from unittest import mock

import flax
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant.rules import quant_rules_scope

import torch_port_anchor_common as anchor_common
import torch_port_multihead_common as common
import torch_port_quant_common as quant_common
from q3d_tpu_torch.models.layers import Conv2d
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

SPARSE, BEV, HEAD = 21, 4, 1 + 3 * 5


@pytest.fixture(scope="module")
def ref():
    return common.build()


def _dynamic(ref, port_rules, jax_rules):
    """A dynamic recipe on both sides -> (the reference's per-conv records,
    the port's quantized model)."""
    with quant_rules_scope(jax_rules):
        shapes = jax.eval_shape(
            lambda k, b: ref["model"].init(k, b, train=False),
            jax.random.PRNGKey(0), ref["batch"])
    # a dynamic recipe's forward reads none of its quant / calib values
    v8 = {k: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    flax.core.unfreeze(shapes[k]))
          for k in shapes if k not in ("params", "batch_stats")}
    v8.update({k: ref["vars"][k] for k in ("params", "batch_stats")})
    _, layers = common.reference_forward(ref, jax_rules, v8)
    model = copy.deepcopy(ref["port"])
    port_api.quantize_model(model, port_rules, ref["port_batch"])
    return layers, model


def test_second_recipe_layers(ref):
    layers, model = _dynamic(ref, port_api.second_recipe(),
                             jax_api.second_recipe())
    n = anchor_common.check_quantized_layers(model, layers,
                                             SPARSE + BEV + HEAD, 2e-6, 2e-3)
    assert n == SPARSE - 1 + BEV + HEAD
    assert model.dense_head.heads[0].conv_cls.rule is not None


def test_int8_deploy_recipe_layers(ref):
    layers, model = _dynamic(ref, port_api.int8_deploy_recipe(),
                             jax_api.int8_deploy_recipe())
    n = anchor_common.check_quantized_layers(model, layers,
                                             SPARSE + BEV + HEAD, 1e-6, 1e-6)
    assert n == SPARSE - 1 + BEV + HEAD
    assert all(m.rule.deploy_int8 and not m.rule.int8_residency
               for m in model.modules() if getattr(m, "rule", None))


def test_residency_deploy_layers(ref):
    rules = jax_api.int8_deploy_recipe(residency=True)
    model, batch = ref["model"], ref["batch"]
    with quant_rules_scope(rules):
        v8 = dict(jax.jit(lambda k, b: model.init(k, b, train=False))(
            jax.random.PRNGKey(0), batch))
    # the reference's quantize_model seeds the quantizers on its initial
    # weights; the port's seed pass takes the same ones
    seed = state_dict_from_jax(quant_common._np(
        {k: v8[k] for k in ("params", "batch_stats")}))
    v8.update({k: ref["vars"][k] for k in ("params", "batch_stats")})
    v8 = jax_api.collect_stats(model, v8, rules, [batch], num_batches=1,
                               loader_to_device=lambda b: b)
    v8 = jax_api.compute_amax(v8, method="max")
    v8 = {k: v for k, v in v8.items() if k != "calib"}
    jref = {"quant": quant_common._np(v8["quant"]), "raw": ref["raw"],
            **quant_common._recorded_forward(model, rules, v8, batch)}

    port = copy.deepcopy(ref["port"])
    with mock.patch.object(port_api, "_seed_state", lambda _: seed):
        port_api.prepare_int8_deploy(port, [ref["port_batch"]])
    n = quant_common.check_same_layers(port, jref)
    assert n > 2 * (SPARSE - 1 + BEV + HEAD)
    ours, theirs = quant_common.amax_pairs(port, jref)
    weights = [k for k in theirs if ".weight_quant." in k]
    assert len(weights) == SPARSE - 1 + BEV + HEAD
    for k in weights:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    port = quant_common.with_reference_amax(port, jref)
    shares = quant_common.check_residency_layers(port, jref,
                                                 SPARSE - 1 + BEV)
    assert min(shares.values()) == 0.0
    head = {name: m for name, m in port.named_modules()
            if name.startswith("dense_head.") and isinstance(m, Conv2d)}
    assert len(head) == HEAD and all(m.residency for m in head.values())
    layers = {p: v for p, v in jref["layers"].items()
              if p.startswith("dense_head.")}
    assert anchor_common.check_quantized_layers(port, layers, HEAD, 1e-6,
                                                1e-6) == HEAD
