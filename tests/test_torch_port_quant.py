"""PyTorch port vs the JAX package: the int8 deploy path, bench recipe.

``int8_deploy_recipe(residency=True, quantize_first_conv=True,
extra_no_list=("dense_head.*",))`` (the recipe ``bench.py`` times; the
port's recipe is always the residency one): every
sparse conv, the first included, and every BEV conv run int8 with int8
residency; the CenterHead stays float.  On centerpoint_tiny with the trained
fixture, batch 2 (``torch_port_quant_common``):

(a) the port quantizes exactly the reference's layers: one quantizer per
    reference ``quant/.../amax`` leaf, none extra;
(b) the port's own calibration gives the reference's amax: weights equal,
    activations within rtol 1e-5;
(c) with the reference's amax loaded, each of the 27 residency layers fed
    the reference's own int8 input gives its int8 output, but at <= 0.1% of
    elements, each off by exactly 1;
(d) end to end: spatial_features within 1e-2 of their max, validity and
    labels equal, boxes and scores within 1e-3 where valid.

The quantizer arithmetic, the histogram calibrator and the reference
paths of the port's quantizable modules are pinned in
``test_torch_port_quantizer.py``: with fewer than five tests this file is
dispatched after ``test_accuracy_regression.py`` under pytest-xdist's
``--dist loadfile``, which hands out files with more tests first.
"""

import pytest
import torch

import torch_port_quant_common as common
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RECIPE = common.BENCH


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
    assert common.check_same_layers(model, ref) == 56


def test_same_amax(calibrated):
    ref, model, _ = calibrated
    common.check_amax(model, ref, act_rtol=1e-5)


def test_residency_layers_int8(with_ref_amax):
    ref, model, _ = with_ref_amax
    common.check_residency_layers(model, ref, expected_layers=21 + 6)


def test_end_to_end(with_ref_amax):
    ref, model, batch = with_ref_amax
    out, jout = common.forward(model, batch, ref)
    common.check_detections_equal(out, jout, tol=1e-3)
