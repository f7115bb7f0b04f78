"""PyTorch port vs the JAX package: the whole model under
``int8_deploy_recipe()``, dynamic per-tensor int8 without residency (what
``tools/test.py --quant int8`` runs).

Every sparse conv but conv_input, every BEV conv, the head's shared conv and
its hidden branch convs are int8, each quantizing its input with the batch's
own amax and handing its f32 output (+ bias) to a float BN and ReLU; the
head's output and heatmap convs stay float.  Nothing is calibrated: the
reference applies its float variables under the rules, and the port's
``quantize_model`` only attaches the rules and creates the quantizers.  On
centerpoint_tiny with the trained fixture, batch 2
(``torch_port_quant_common``), measured here:

* each of the 48 convs fed the reference's own input gives its output within
  1e-6 of the output's largest magnitude (float sums in another order, the
  rescale ``s_act * s_w`` in another association; the int8 operands are
  equal, and an s32 sum off by one unit would miss by more than that);
* end to end, spatial_features within 1e-6 of their largest magnitude, and
  the detections slot for slot: the same valid slots and labels, boxes and
  scores within 1e-4 (measured 3e-6 and 6e-7).
"""

import numpy as np
import pytest
import torch

import torch_port_quant_common as common
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RECIPE = {}
LAYER_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    ref = common.reference_dynamic(RECIPE)
    model, batch = common.port_dynamic(ref, RECIPE)
    return ref, model, batch


def test_rules_attached(setup):
    """The layers the recipe quantizes: 20 sparse convs, the 6 BEV convs,
    the head's shared conv and its 8 hidden regression convs; the heatmap
    branch and every output conv stay float."""
    _, model, _ = setup
    rules = {name: m.rule for name, m in
             common.port_quant.quantizable_modules(model)}
    int8 = [n for n, r in rules.items() if r is not None]
    assert all(rules[n].deploy_int8 and not rules[n].int8_residency
               and rules[n].act.dynamic for n in int8)
    assert sum(n.startswith("backbone_3d") for n in int8) == 20
    assert sum(n.startswith("backbone_2d") for n in int8) == 6
    head = [n for n in int8 if n.startswith("dense_head.")
            and n != "dense_head.shared_requant"]
    assert len(head) == 1 + 2 * 4 and "dense_head.shared_conv.0" in head
    assert not any(".hm." in n for n in head)
    # the DenseRequant quantizes only under residency
    assert not model.dense_head.shared_requant.residency


def test_convs_fed_reference_inputs(setup):
    ref, model, _ = setup
    report = common.check_conv_layers(model, ref, expected=48,
                                      sparse_rtol=LAYER_RTOL,
                                      dense_rtol=LAYER_RTOL)
    assert sum(p.startswith("backbone_2d") for p in report) == 6


def test_end_to_end(setup):
    ref, model, batch = setup
    with torch.no_grad():
        out = model(dict(batch))
    jout = ref["out"]
    sf = out["spatial_features"]
    jsf = jout["spatial_features"].transpose(0, 3, 1, 2)
    assert sf.dtype == torch.float32 and jsf.dtype == np.float32
    assert np.abs(sf.numpy() - jsf).max() <= LAYER_RTOL * np.abs(jsf).max()
    ours = {k: v.numpy() for k, v in out.items() if k.startswith("final_")}
    np.testing.assert_array_equal(ours["final_valid"], jout["final_valid"])
    assert jout["final_valid"].sum() > 5                # it detects
    common.check_detections_equal(ours, jout, tol=1e-4)
