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

Also pinned here: the quantizer arithmetic and the histogram calibrator
against the reference's functions, and the reference paths of the port's
quantizable modules.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from q3d_tpu.quant import tensor_quant as jax_tq

import torch_port_quant_common as common
from q3d_tpu_torch.quant import tensor_quant as port_tq
from q3d_tpu_torch.utils.weights import _module_rules, reference_module_path
from test_torch_port_centerpoint import _port_model

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False], ids=["jit", "eager"])
def test_quantize_to_int_rounds_as_reference(dtype, fused):
    """quantize_to_int against the reference's, jitted (XLA: the scale by
    the f32 reciprocal of 127; a bf16 batch's amax kept in f32) and op by
    op, on values crowding the rounding boundaries."""
    rng = np.random.RandomState(0)
    scale = np.float32(0.8094372)
    x = np.concatenate([(np.arange(-126, 126) + 0.5) * scale,
                        rng.randn(20000) * 20]).astype(np.float32)
    x = x.astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16" else x.dtype)
    jx = jnp.asarray(x)

    def ref_fn(v):
        amax = jnp.max(jnp.abs(v))
        if fused:
            amax = amax.astype(jnp.float32)
        return jax_tq.quantize_to_int(v, jnp.maximum(amax, 1e-12))
    if fused:
        q_ref, s_ref = jax.jit(ref_fn)(jx)
    else:
        with jax.disable_jit():
            q_ref, s_ref = ref_fn(jx)
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    amax = t.abs().amax()
    q, s = port_tq.quantize_to_int(t, amax.float() if fused else amax,
                                   fused=fused)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert float(s) == float(np.asarray(s_ref).astype(np.float32))


def test_histogram_calibrator_matches_reference():
    """Three batches, the range growing by integer factors: the port's
    histogram, bin width and committed 'max' amax equal the reference's
    ``_update_histogram`` and ``compute_amax_from_hist``."""
    rng = np.random.RandomState(1)
    batches = [rng.randn(5000).astype(np.float32) * s for s in (0.01, 3.0, 2.0, 40.0)]
    spec = port_tq.QuantSpec(8, axis=None, dynamic=False, calibrator="histogram")
    q = port_tq.TensorQuantizer(spec)
    hist = jnp.zeros(jax_tq.NUM_HIST_BINS, jnp.float32)
    width = jnp.zeros((), jnp.float32)
    for b in batches:
        q(torch.from_numpy(b), calibrating=True)
        hist, width = jax.jit(jax_tq._update_histogram)(
            jnp.abs(jnp.asarray(b)), hist, width)
    np.testing.assert_array_equal(q.hist.numpy(), np.asarray(hist))
    assert float(q.bin_width) == float(width)
    q.commit_amax()
    want = np.float32(jax_tq.compute_amax_from_hist(hist, width, "max"))
    assert float(q.amax) == float(want)
    assert float(q.absmax) == max(float(np.abs(b).max()) for b in batches)


def test_uncalibrated_static_quantizer_raises():
    spec = port_tq.QuantSpec(8, axis=None, dynamic=False, calibrator="histogram")
    with pytest.raises(RuntimeError, match="no calibrated amax"):
        port_tq.TensorQuantizer(spec)(torch.ones(4))


def test_reference_paths_round_trip():
    """Every quantizable module of the ref-width port has a reference path,
    and the weights carry-over's rules map that path back to the module."""
    _, _, _, model = _port_model("centerpoint_ref")
    names = [n for n, m in model.named_modules() if hasattr(m, "QUANT_KIND")]
    # sparse, BEV, shared conv and requant, 3 heads x 6 branches x 2 convs
    assert len(names) == 21 + 12 + 2 + 3 * 6 * 2
    for name in names:
        path = reference_module_path(name)
        assert path is not None, name
        module, *toks = path.split(".")
        back = _module_rules(module, toks)
        if isinstance(back, tuple):                     # a branch's output conv
            _, head, branch = back
            assert name.startswith(f"{module}.heads_list.{head}.{branch}."), name
        else:
            assert f"{module}.{back}" == name, (name, path)
