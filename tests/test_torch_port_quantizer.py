"""PyTorch port vs the JAX package: the int8 quantizer's parts, without a
model.  ``quantize_to_int`` rounds as the reference's, jitted and op by op;
the histogram calibrator gives the reference's histogram, bin width and
"max" amax; an uncalibrated static quantizer raises; every quantizable
module of the ref-width port has a reference path that the weight
carry-over's rules map back to it.  (These lived in
``test_torch_port_quant.py`` beside the bench recipe's model-level tests.)
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from q3d_tpu.quant import tensor_quant as jax_tq

from q3d_tpu_torch.quant import tensor_quant as port_tq
from q3d_tpu_torch.utils.weights import _module_rules, reference_module_path

from test_torch_port_centerpoint import _port_model
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


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
    # sparse, BEV, the 2 deblocks' transposed convs, shared conv and
    # requant, 3 heads x 6 branches x 2 convs
    assert len(names) == 21 + 12 + 2 + 2 + 3 * 6 * 2
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
