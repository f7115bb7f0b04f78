"""PyTorch port vs the JAX package: the sparse gather-conv's plain
version against the Pallas kernel (interpret mode) and its XLA reference
in f32 on random sparse tensors (moved out of ``test_torch_port_spconv.py``
so that each file keeps at most 5 tests and ``--dist loadfile``
dispatches ``test_accuracy_regression.py`` early).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.ops.spconv import engine, gather_conv

from test_torch_port_spconv import (RANDOM_CASES, WIDE_CASES, _chunk_refs,
                                    _port_tensor)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,n_active,capacity,cin,cout",
                         RANDOM_CASES + WIDE_CASES)
def test_gather_conv_matches_pallas_kernel_f32(seed, n_active, capacity, cin,
                                               cout):
    rng = np.random.RandomState(seed)
    st, _ = _sorted_sparse(rng, 2, (4, 10, 16), n_active, cin, capacity)
    w = rng.randn(27, cin, cout).astype(np.float32) * 0.1
    ref, pal = _chunk_refs(st, jnp.asarray(w))
    pst = _port_tensor(st)
    out = gather_conv.sparse_gather_conv(
        pst.features, engine.subm_gather_indices(pst, 3), torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
