"""PyTorch port vs the JAX package: the sparse gather-conv in bf16 and s8
(scale and row mask), the (3,1,1) conv_out book, and the rulebooks of a
tiny frame (moved out of ``test_torch_port_spconv.py`` so that each file
keeps at most 5 tests and ``--dist loadfile`` dispatches
``test_accuracy_regression.py`` early).
"""

import jax.numpy as jnp
import numpy as np
import torch

from q3d_tpu.ops.spconv import engine as jax_engine
from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.ops.spconv import SparseConvTensor, engine, gather_conv

from test_torch_port_spconv import (  # noqa: F401 (tiny_input: a fixture)
    _chunk_refs, _eq, _port_tensor, tiny_input)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)


def test_gather_conv_int8_with_scale_and_valid_exact():
    rng = np.random.RandomState(3)
    spatial, cin, cout = (3, 8, 12), 4, 8
    st, _ = _sorted_sparse(rng, 1, spatial, 200, cin, 256)
    q = rng.randint(-127, 128, size=(256, cin)).astype(np.int8)
    st = st.replace(features=jnp.asarray(q))
    w = rng.randint(-127, 128, size=(27, cin, cout)).astype(np.int8)
    scale = rng.rand(1, cout).astype(np.float32)
    valid = st.indices[:, 0] >= 0
    ref, pal = _chunk_refs(st, jnp.asarray(w), out_valid=valid,
                           out_scale=jnp.asarray(scale))
    ref_sums, _ = _chunk_refs(st, jnp.asarray(w))

    pst = _port_tensor(st)
    book = engine.subm_gather_indices(pst, 3)
    wt = torch.from_numpy(w)
    sums = gather_conv.sparse_gather_conv(pst.features, book, wt)
    out = gather_conv.sparse_gather_conv(
        pst.features, book, wt, out_scale=torch.from_numpy(scale[0]),
        out_valid=torch.from_numpy(np.array(valid)))
    assert sums.dtype == out.dtype == torch.float32
    # the s32 sums before scaling are exact, and so is the epilogue
    np.testing.assert_array_equal(sums.numpy(), ref_sums)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), pal)


def test_gather_conv_matches_pallas_kernel_bf16():
    rng = np.random.RandomState(8)
    st, _ = _sorted_sparse(rng, 2, (4, 10, 16), 300, 16, 384)
    f = jnp.asarray(np.asarray(st.features), jnp.bfloat16)
    st = st.replace(features=f)
    w = jnp.asarray(rng.randn(27, 16, 32).astype(np.float32) * 0.1,
                    jnp.bfloat16)
    ref, pal = _chunk_refs(st, w)
    pst = _port_tensor(st.replace(features=f.astype(jnp.float32)))
    out = gather_conv.sparse_gather_conv(
        pst.features.to(torch.bfloat16), engine.subm_gather_indices(pst, 3),
        torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    for r in (ref, pal):
        r = np.asarray(r, np.float32)
        assert np.abs(r).max() > 0.1
        np.testing.assert_allclose(out, r, rtol=2.0 ** -7, atol=1e-6)


def test_tiny_frame_rulebooks_match_reference(tiny_input):
    ours, ref = tiny_input
    _eq(ours.indices, ref.indices)
    np.testing.assert_array_equal(ours.features.numpy(),
                                  np.asarray(ref.features))
    _eq(engine.subm_gather_indices(ours, 3),
        jax_engine.subm_gather_indices(ref, 3))
    # conv2's downsample, then the stage's SubM book on its output
    o_idx, o_book, o_sp = engine.sparse_conv_downsample(ours, 3, 2, 1)
    r_idx, r_book, r_sp = jax_engine.sparse_conv_downsample(ref, 3, 2, 1)
    assert o_sp == r_sp
    _eq(o_idx, r_idx)
    _eq(o_book, r_book)
    o2 = SparseConvTensor(features=torch.zeros(o_idx.shape[0], 1),
                          indices=o_idx, spatial_shape=o_sp,
                          batch_size=ours.batch_size, sorted_rows=True)
    r2 = ref.__class__(features=jnp.zeros((r_idx.shape[0], 1)),
                       indices=r_idx, spatial_shape=r_sp,
                       batch_size=ref.batch_size, sorted_rows=True)
    _eq(engine.subm_gather_indices(o2, 3), jax_engine.subm_gather_indices(r2, 3))


def test_gather_conv_conv_out_book_matches_reference():
    """The (M, 3) book of the (3,1,1) z-compressing conv_out."""
    rng = np.random.RandomState(7)
    st, _ = _sorted_sparse(rng, 2, (5, 10, 16), 380, 16, 384)
    w = rng.randn(3, 16, 32).astype(np.float32) * 0.1
    r_idx, r_book, _ = jax_engine.sparse_conv_downsample(st, (3, 1, 1),
                                                         (2, 1, 1), 0)
    ref = jax_engine.gather_conv(st.features, r_book, jnp.asarray(w),
                                 out_valid=r_idx[:, 0] >= 0)
    pst = _port_tensor(st)
    o_idx, o_book, _ = engine.sparse_conv_downsample(pst, (3, 1, 1),
                                                     (2, 1, 1), 0)
    out = gather_conv.sparse_gather_conv(pst.features, o_book,
                                         torch.from_numpy(w),
                                         out_valid=o_idx[:, 0] >= 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
