"""PyTorch port vs the JAX package: the int8 deploy path, entry recipe.

``prepare_int8_deploy(model, vars, [batch], residency=True)`` with default
kwargs (the recipe ``__graft_entry__.py`` runs; the port's
``prepare_int8_deploy(model, [batch, batch])``): conv_input stays float, so
the first residual block's identity is float; every other sparse conv and
every BEV conv is int8 with residency, and so are the head's shared conv
and its hidden branch convs, fed through the DenseRequant.  On
centerpoint_tiny with the trained fixture, batch 2
(``torch_port_quant_common``):

(a) the port quantizes exactly the reference's layers (65 quantizers);
(c) with the reference's amax loaded, each of the 27 residency layers fed
    the reference's own input gives its int8 output, but at <= 0.1% of
    elements, each off by exactly 1: 20 sparse convs, 6 BEV convs, and the
    head's shared conv -> BN -> ReLU -> DenseRequant; and each int8 hidden
    branch conv of the head (fed the reference's int8 shared map) gives the
    reference's raw f32 output within 1e-6 of its largest magnitude, which
    leaves room for the rescale's association (below) and for nothing
    else: a wrong scale would be off by at least 1/127.

(b) and (d) are held at looser tolerances than the bench recipe's, for a
reason measured here: in this model XLA computes several convs' rescale
``s_in * s_w`` in another association than the one the port follows (the
raw conv outputs differ by up to 2e-7 relative), so a few int8 roundings
flip, and each flip spreads through the int8 layers after it.  Measured:
activation amax within 6.2e-3 relative, boxes within 0.07 and scores within
0.025 of their matched reference detection, two near-equal scores swapping
slots.  So (b) holds weights equal and activations within rtol 1e-2, and
(d) holds spatial_features within 1e-2 of their max, the same valid count,
and every reference detection matched by label with its box within 0.1 and
its score within 0.05.
"""

import pytest
import torch

import torch_port_quant_common as common

torch.set_num_threads(2)
RECIPE = common.ENTRY


@pytest.fixture(scope="module")
def calibrated():
    ref = common.reference(RECIPE)
    model, batch = common.port(ref, RECIPE)
    return ref, model, batch


@pytest.fixture(scope="module")
def with_ref_amax(calibrated):
    ref, model, batch = calibrated
    return ref, common.with_reference_amax(model, ref), batch


def test_same_quantized_layers(calibrated):
    ref, model, _ = calibrated
    assert common.check_same_layers(model, ref) == 65


def test_same_amax(calibrated):
    ref, model, _ = calibrated
    common.check_amax(model, ref, act_rtol=1e-2)


def test_residency_layers_int8(with_ref_amax):
    ref, model, _ = with_ref_amax
    common.check_residency_layers(model, ref, expected_layers=20 + 6 + 1)


def test_head_branch_convs(with_ref_amax):
    ref, model, _ = with_ref_amax
    # 2 heads x the 4 int8 hidden convs (center, center_z, dim, rot)
    common.check_head_branch_convs(model, ref, expected_layers=2 * 4,
                                   rtol=1e-6)


def test_end_to_end(with_ref_amax):
    ref, model, batch = with_ref_amax
    out, jout = common.forward(model, batch, ref)
    common.check_detections_matched(out, jout, box_tol=0.1, score_tol=0.05)


def test_head_runs_int8(with_ref_amax):
    """The head's shared map is quantized once and its hidden branch convs
    take it as int8; the heatmap branch (excluded) dequantizes it."""
    _, model, _ = with_ref_amax
    head = model.dense_head
    assert head.shared_requant.residency and head.shared_conv[0].residency
    for branches in head.heads_list:
        for name in branches.names:
            hidden = getattr(branches, name)[0][0]
            assert (hidden.rule is None) == (name == "hm"), name
