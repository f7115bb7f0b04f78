"""PyTorch port vs the JAX package: the fake-mode ``TensorQuantizer``
(dynamic per tensor and per axis, static max and histogram) and the
entropy amax on sparse histograms (moved out of
``test_torch_port_fakequant.py``, whose module docstring states what they
hold, so that each file keeps at most 5 tests and ``--dist loadfile``
dispatches ``test_accuracy_regression.py`` early).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.quant import tensor_quant as jax_tq
from q3d_tpu.quant.rules import QuantSpec as JaxQuantSpec

from q3d_tpu_torch.quant import calib as port_calib
from q3d_tpu_torch.quant import tensor_quant as port_tq
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("axis,calibrator", [(None, "max"), (1, "max"),
                                             (None, "histogram")])
def test_fake_quantizer_matches_reference(axis, calibrator):
    """Dynamic; then static: two calibration batches (passed through),
    committed by "max" (and "entropy" for the histogram), then quantizing."""
    rng = np.random.RandomState(5)
    batches = [rng.randn(300, 24).astype(np.float32) * s for s in (1.0, 3.0)]
    dyn = port_tq.QuantSpec(8, axis=axis, dynamic=True)
    jq = jax_tq.TensorQuantizer(JaxQuantSpec(8, axis=axis, dynamic=True))
    pq = port_tq.TensorQuantizer(dyn, mode="fake")
    want = jq.apply({}, jnp.asarray(batches[0]))
    np.testing.assert_array_equal(pq(torch.from_numpy(batches[0])).numpy(),
                                  np.asarray(want))

    spec = dict(axis=axis, dynamic=False, calibrator=calibrator)
    jq = jax_tq.TensorQuantizer(JaxQuantSpec(8, **spec))
    shape = () if axis is None else (24,)
    pq = port_tq.TensorQuantizer(port_tq.QuantSpec(8, **spec), shape,
                                 mode="fake")
    # never calibrated (amax 0): pass-through on both sides
    v = jq.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    v = {"quant": v["quant"]}
    np.testing.assert_array_equal(
        np.asarray(jq.apply(v, jnp.asarray(batches[1]))), batches[1])
    np.testing.assert_array_equal(pq(torch.from_numpy(batches[1])).numpy(),
                                  batches[1])
    v = {"quant": v["quant"], "calib": jax.tree_util.tree_map(
        jnp.zeros_like, jq.init(jax.random.PRNGKey(0),
                                jnp.asarray(batches[0]))["calib"])}
    for b in batches:
        y, mut = jq.apply(v, jnp.asarray(b), mutable=["calib"])
        v = {"quant": v["quant"], "calib": mut["calib"]}
        np.testing.assert_array_equal(np.asarray(y), b)
        np.testing.assert_array_equal(
            pq(torch.from_numpy(b), calibrating=True).numpy(), b)
    for method in ("max", "entropy") if calibrator == "histogram" else ("max",):
        quant = jax_tq.resolve_amax(v["calib"], v["quant"], method=method)
        pq.commit_amax(method)
        np.testing.assert_array_equal(pq.amax.numpy(),
                                      np.asarray(quant["amax"]))
        for b in batches:
            np.testing.assert_array_equal(
                pq(torch.from_numpy(b)).numpy(),
                np.asarray(jq.apply({"quant": quant}, jnp.asarray(b))))


def test_entropy_amax_equals_reference_loops_on_sparse_histograms():
    """Mostly-empty histograms (levels with no filled bin, an empty tail):
    the vectorised candidates equal the reference's Python loops."""
    rng = np.random.RandomState(3)
    for n_filled in (5, 700):
        h = np.zeros(2048)
        h[rng.choice(2048, n_filled, replace=False)] = rng.randint(1, 50,
                                                                   n_filled)
        assert port_calib._entropy_amax(h, 0.01) \
            == jax_tq._entropy_amax(h, 0.01)
