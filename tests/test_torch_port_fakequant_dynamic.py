"""PyTorch port vs the JAX package: the dynamic SmoothQuant recipe, the
reference's default mode, on the trained model.

Under ``centerpoint_recipe(sq=True, alpha=0.5, static=False)`` on the
trained centerpoint_tiny fixture (test frames 0-1, batch 2, f32): the port
quantizes the reference's layers (one quantizer per ``quant/.../amax``
leaf; dynamic, so every committed amax is 0 on both sides; and the static
SmoothQuant recipe's whole reference tree loads with ``strict=True``); each conv fed
the reference's own input agrees within 2e-6 of its output's scale (sparse
and float convs: equal quantized inputs, f32 sums in another order) or
2e-3 (the dense SmoothQuant convs, whose column scales come from XLA's
jitted ``pow``, an ulp off PyTorch's in a third of the columns); end to
end, the flipped roundings carry through, so the detections are held as
sets (``check_detections_near``); ``layer_l1_diff``'s rows for the sparse
and BEV convs agree with the reference's within 2% of their value, and
``top_magnitudes`` with the reference's.

The reference model is quantized by a jitted ``model.init`` under the
recipe (the variables ``quantize_model`` builds with its eager one): a
dynamic recipe's forward reads none of the values that pass records.
"""

import jax
import numpy as np
import pytest
import torch

from q3d_tpu.quant import api as jax_api
from q3d_tpu.quant import sensitivity as jax_sens
from q3d_tpu.quant.rules import quant_rules_scope

import torch_port_quant_common as common
from q3d_tpu_torch.quant import api as port_api
from q3d_tpu_torch.quant import sensitivity as port_sens

torch.set_num_threads(2)
RECIPE = dict(sq=True, alpha=0.5, static=False)
SPARSE_RTOL = 2e-6      # equal quantized inputs, f32 sums in another order
DENSE_RTOL = 2e-3       # an ulp of XLA's pow flips the odd act rounding


@pytest.fixture(scope="module")
def dynamic_sq():
    ref = common.reference_fake(RECIPE, jit_init=True)
    model, batch = common.port_fake(ref, RECIPE)
    return ref, model, batch


def test_dynamic_sq_quantizes_the_reference_layers(dynamic_sq):
    """One port quantizer per reference amax leaf (dynamic: every one 0 on
    both sides); and the reference's whole variable tree under the static
    SmoothQuant recipe (every amax, each conv's ``sq_act_amax``) loads into
    the port's model quantized by that recipe with ``strict=True``."""
    ref, model, batch = dynamic_sq
    assert common.check_same_layers(model, ref) == 70
    ours, theirs = common.amax_pairs(model, ref)
    for key, want in theirs.items():           # dynamic: never committed
        np.testing.assert_array_equal(ours[key], want, err_msg=key)
        assert not want.any()
    with quant_rules_scope(jax_api.centerpoint_recipe(sq=True, static=True)):
        tree = jax.jit(lambda k, b: ref["model"].init(k, b, train=False))(
            jax.random.PRNGKey(0), ref["batch"])
    state = common.state_dict_from_jax(common._np(
        {k: tree[k] for k in ("params", "batch_stats", "quant")}))
    assert sum(k.endswith("sq_act_amax") for k in state) == 15
    static_sq, _ = common.port_model(ref)
    port_api.quantize_model(static_sq, port_api.centerpoint_recipe(
        sq=True, static=True), batch)
    static_sq.load_state_dict(state, strict=True)


def test_dynamic_sq_conv_layers(dynamic_sq):
    """Each of the 21 sparse, 6 BEV and 21 head convs fed the reference's
    own input (sparse and float convs to 2e-6, SmoothQuant convs to 2e-3
    of their output's scale)."""
    ref, model, _ = dynamic_sq
    common.check_conv_layers(model, ref, 21 + 6 + 21, SPARSE_RTOL, DENSE_RTOL)


def test_dynamic_sq_end_to_end(dynamic_sq):
    """spatial_features within 1e-2 of their scale; the detections as sets:
    counts within 2, and 95% of the detections scoring >= 0.15 (the
    threshold is 0.1) have a partner within 0.1 m / 0.02 in score (one
    flipped detection near a decision is 2% of the ~50 of two frames)."""
    ref, model, batch = dynamic_sq
    with torch.no_grad():
        out = model(dict(batch))
    jout = ref["out"]
    sf = out["spatial_features"].numpy()
    jsf = jout["spatial_features"].transpose(0, 3, 1, 2)
    assert np.abs(sf - jsf).max() <= 1e-2 * np.abs(jsf).max()
    assert jout["final_valid"].sum() > 5
    common.check_detections_near(
        {k: v.numpy() for k, v in out.items() if k.startswith("final_")},
        jout, box_tol=0.1, score_tol=0.02, min_score=0.15, max_count_diff=2,
        min_share=0.95)


def test_layer_l1_diff_matches_reference(dynamic_sq):
    """``layer_l1_diff``'s rows (path, mean L1, relative L1) for the sparse
    and BEV convs name the reference's layers, and their relative L1 agree
    within 2% (the fake-quant roundings flipped on either side move it)."""
    ref, model, batch = dynamic_sq
    float_model = common.float_copy(model)
    rows = {r[0]: r for r in port_sens.layer_l1_diff(float_model, model,
                                                     batch, top=200)}
    jrows = {r[0]: r for r in common.reference_l1_rows(ref)}
    assert len([n for n in rows if n.startswith(("backbone_3d",
                                                 "backbone_2d"))]) == 27
    checked = 0
    for name in rows:
        if not name.startswith(("backbone_3d", "backbone_2d")) \
                or "conv_input" in name:
            continue
        assert name in jrows, name
        _, l1, rel = rows[name]
        _, jl1, jrel = jrows[name]
        assert jrel > 0 and abs(rel - jrel) <= 0.02 * jrel, (name, rel, jrel)
        checked += 1
    assert checked == 26


def test_top_magnitudes_match_reference(dynamic_sq):
    """The largest |weight| entries of every conv, by the port's name, equal
    the reference's of the same parameter."""
    ref, model, _ = dynamic_sq
    theirs = jax_sens.top_magnitudes({"params": ref["float"]["params"]}, k=5)
    ours = port_sens.top_magnitudes(model, k=5)
    pairs = {"backbone_3d.conv1.0.conv1.weight":
             "backbone_3d.conv1_0.conv1.weight",
             "backbone_2d.blocks.1.4.weight": "backbone_2d.blocks_1.conv1.kernel",
             "dense_head.shared_conv.0.weight": "dense_head.shared_conv.kernel"}
    for port_name, ref_name in pairs.items():
        np.testing.assert_array_equal(ours[port_name], theirs[ref_name])
    assert len(ours) == len(theirs)
