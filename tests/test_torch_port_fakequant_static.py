"""PyTorch port vs the JAX package: static fake-quant PTQ with entropy amax
on the trained model (``centerpoint_recipe(sq=False, static=True)``: every
sparse conv but the first and every hidden conv of the BEV backbone and the
head fake-quantized, activations per tensor from 2048-bin histograms).

Both packages quantize the model (the seed pass) -> ``collect_stats``
(the first test batch given three times) -> ``compute_amax("entropy")``
on centerpoint_tiny with the trained fixture (test frames 0-1, batch 2,
f32).  To keep the file's time down, two steps of the reference run in
faster equivalents: its seed pass is a jitted ``model.init`` under the
recipe (``quantize_model`` runs it eagerly; the two differ by rounding
only, inside (b)'s tolerance), and its entropy sweep is the port's
vectorised ``_entropy_amax`` (held equal to the reference's loops on two
of this run's real histograms below, and on seeded ones in
``test_torch_port_fakequant.py``).

(a) the same quantized layers: one port quantizer per reference amax leaf;
(b) the port's own calibration: weight amax equal; activation amax within
    rtol 1e-5 (the seed pass's float convs sum in another order, which
    moves a histogram's first bin width, and so the amax, by a few f32
    ulps);
(c) with the reference's amax loaded through the weights carry-over, each
    of the 48 convs fed the reference's own input agrees within 2e-6 of
    its output's scale (the fake-quantized operands are equal; the sums
    run in another order);
(d) end to end with the port's own amax, detections as sets (counts within
    2, 95% of the detections scoring >= 0.15 with a partner within 0.1 m
    and 0.02 in score).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from q3d_tpu.quant import tensor_quant as jax_tq

import torch_port_quant_common as common
from q3d_tpu_torch.quant import calib as port_calib

torch.set_num_threads(2)
RECIPE = dict(sq=False, static=True)
CALIB_BATCHES = 3
LAYER_RTOL = 2e-6


@pytest.fixture(scope="module")
def calibrated():
    with mock.patch.object(jax_tq, "_entropy_amax", port_calib._entropy_amax):
        ref = common.reference_fake(RECIPE, CALIB_BATCHES, "entropy",
                                    jit_init=True)
    model, batch = common.port_fake(ref, RECIPE, CALIB_BATCHES, "entropy")
    return ref, model, batch


def _histograms(calib, path=()):
    for k, v in calib.items():
        if isinstance(v, dict):
            yield from _histograms(v, path + (k,))
        elif k == "hist":
            yield path, v, calib["bin_width"]


def test_entropy_amax_equals_reference_on_real_histograms(calibrated):
    ref, _, _ = calibrated
    hists = list(_histograms(ref["calib"]))
    assert len(hists) == 35
    for path, hist, width in hists[::18]:
        h = np.asarray(hist, np.float64)
        assert port_calib._entropy_amax(h, float(width)) \
            == jax_tq._entropy_amax(h, float(width)), path


def test_same_quantized_layers(calibrated):
    ref, model, _ = calibrated
    assert common.check_same_layers(model, ref) == 70


def test_same_amax(calibrated):
    ref, model, _ = calibrated
    assert common.check_amax(model, ref, act_rtol=1e-5) > 0


def test_conv_layers(calibrated):
    ref, model, _ = calibrated
    common.check_conv_layers(common.with_reference_amax(model, ref), ref,
                             21 + 6 + 21, LAYER_RTOL, LAYER_RTOL)


def test_end_to_end(calibrated):
    ref, model, batch = calibrated
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
