"""PyTorch port vs the JAX package: the whole model under
``int8_deploy_recipe(static=True)``, the hybrid static form without
residency: every int8 conv quantizes its input per tensor with a calibrated
amax (2048-bin histograms, method "max"), the weights per output channel
from each forward, and hands its f32 output (+ bias) to a float BN and ReLU.

Both packages run the seed pass (the reference's a jitted ``model.init``
under the recipe), ``collect_stats`` on the first test batch given twice
and ``compute_amax("max")``, on centerpoint_tiny with the trained fixture
(batch 2, f32), measured here:

(a) the same quantized layers: one port quantizer per reference amax leaf;
(b) the port's own calibration: weight amax equal, activation amax within
    rtol 1e-3 (measured 1.4e-4: the seed pass's float sums run in another
    order, which moves a histogram's first bin width by ulps, and a static
    scale an ulp away flips the odd int8 rounding after it);
(c) with the reference's amax loaded through the weights carry-over, each
    of the 48 convs fed the reference's own input within 1e-6 of its
    output's largest magnitude (equal int8 operands; the rescale's
    association moves the last bits; an s32 sum off by one unit would miss
    by more);
(d) end to end with the reference's amax: XLA associates ``s_act * s_w``
    otherwise in some convs of the whole graph (the raw outputs of 7 of the
    20 int8 sparse convs differ in their last bits), so a few int8 roundings
    flip with the static scales and spread.  spatial_features within 1e-2
    of their largest magnitude (measured 2.7e-3), the same valid slots, and
    every reference detection matched by label with its box within 0.07
    and its score within 0.025 (measured 0.027 and 0.0085), the tolerances
    of ``test_torch_port_quant_entry.py``.
"""

import numpy as np
import pytest
import torch

import torch_port_quant_common as common
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
RECIPE = dict(static=True)
CALIB_BATCHES = 2
LAYER_RTOL = 1e-6


@pytest.fixture(scope="module")
def calibrated():
    ref = common.reference_static(RECIPE, CALIB_BATCHES, "max")
    model, batch = common.port_static(ref, RECIPE, CALIB_BATCHES, "max")
    return ref, model, batch


def test_same_quantized_layers(calibrated):
    ref, model, _ = calibrated
    assert common.check_same_layers(model, ref) > 0


def test_same_amax(calibrated):
    ref, model, _ = calibrated
    assert common.check_amax(model, ref, act_rtol=1e-3) >= 0


def test_conv_layers(calibrated):
    ref, model, _ = calibrated
    common.check_conv_layers(common.with_reference_amax(model, ref), ref, 48,
                             LAYER_RTOL, LAYER_RTOL)


def test_end_to_end(calibrated):
    ref, model, batch = calibrated
    with torch.no_grad():
        out = common.with_reference_amax(model, ref)(dict(batch))
    jout = ref["out"]
    sf = out["spatial_features"].numpy()
    jsf = jout["spatial_features"].transpose(0, 3, 1, 2)
    assert np.abs(sf - jsf).max() <= 1e-2 * np.abs(jsf).max()
    ours = {k: v.numpy() for k, v in out.items() if k.startswith("final_")}
    np.testing.assert_array_equal(ours["final_valid"], jout["final_valid"])
    assert jout["final_valid"].sum() > 5
    common.check_detections_matched(ours, jout, box_tol=0.07, score_tol=0.025)
