"""PyTorch port vs the JAX package: sparse-conv rulebooks and kernel 1's
function (the sparse gather-conv that ``pallas_conv.py`` runs on the TPU).

Rulebooks are integer tables and must be exactly equal.  The gather-conv is
held against the Pallas kernel in interpret mode and against the reference's
chunked gather path: f32 within 1e-5 (summation order only), s8 exact, bf16
within one bf16 ulp (2^-7 relative: both round an f32 sum, taken in another
order, to bf16 once).  The gather-conv's cases and the rulebooks of a
tiny frame live in ``test_torch_port_spconv_kernel.py`` (f32) and
``..._spconv_book.py`` (bf16, s8, conv_out's book, the tiny frame), so
that each file keeps at most 5 tests and ``--dist loadfile`` dispatches
``test_accuracy_regression.py`` early.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from q3d_tpu.models.backbones_3d import spconv_backbone as jax_backbone
from q3d_tpu.ops.spconv import engine as jax_engine
from q3d_tpu.ops.spconv import pallas_conv
from tests.test_pallas_conv import _sorted_sparse

from q3d_tpu_torch.config import cfg_from_yaml_file, EDict
from q3d_tpu_torch.datasets import build_dataloader
from q3d_tpu_torch.models.backbones_3d import spconv_backbone as port_backbone
from q3d_tpu_torch.ops.spconv import SparseConvTensor, engine, gather_conv
from q3d_tpu_torch.ops.spconv.modules import SubMConv3d, SparseConv3d
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)

CFG = Path(__file__).resolve().parent.parent / "tools" / "cfgs" / \
    "synthetic_models" / "centerpoint_tiny.yaml"


def _port_tensor(st):
    """JAX SparseConvTensor -> the port's, same rows."""
    return SparseConvTensor(
        features=torch.from_numpy(np.array(st.features)),
        indices=torch.from_numpy(np.array(st.indices)),
        spatial_shape=tuple(int(s) for s in st.spatial_shape),
        batch_size=int(st.batch_size), sorted_rows=bool(st.sorted_rows))


def _eq(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.astype(np.int64), ref.astype(np.int64))


RANDOM_CASES = [(0, 300, 384, 4, 8), (1, 380, 384, 8, 16), (2, 640, 640, 4, 4)]


@pytest.mark.parametrize("seed,n_active,capacity,cin,cout", RANDOM_CASES)
def test_subm_rulebook_matches_reference(seed, n_active, capacity, cin, cout):
    st, _ = _sorted_sparse(np.random.RandomState(seed), 2, (4, 10, 16),
                           n_active, cin, capacity)
    _eq(engine.subm_gather_indices(_port_tensor(st), 3),
        jax_engine.subm_gather_indices(st, 3))


@pytest.mark.parametrize("kernel,stride,padding,out_capacity", [
    (3, 2, 1, None),
    (3, 2, 1, 96),               # overflow: the lowest 96 keys are kept
    (3, 2, (0, 1, 1), None),
    ((3, 1, 1), (2, 1, 1), 0, 200),
])
def test_downsample_rulebook_matches_reference(kernel, stride, padding,
                                               out_capacity):
    st, _ = _sorted_sparse(np.random.RandomState(5), 2, (5, 10, 16), 380, 4,
                           384)
    o_idx, o_book, o_sp = engine.sparse_conv_downsample(
        _port_tensor(st), kernel, stride, padding, out_capacity)
    r_idx, r_book, r_sp = jax_engine.sparse_conv_downsample(
        st, kernel, stride, padding, out_capacity)
    assert o_sp == r_sp
    _eq(o_idx, r_idx)
    _eq(o_book, r_book)
    if out_capacity == 96:                       # the case really overflows
        full, _ = engine.downsample_out_keys(_port_tensor(st), kernel, stride,
                                             padding)
        assert int((full[:, 0] >= 0).sum()) > out_capacity
    # the key-only builder agrees with the full one
    k_idx, _ = engine.downsample_out_keys(_port_tensor(st), kernel, stride,
                                          padding, out_capacity)
    _eq(k_idx, r_idx)


@pytest.fixture(scope="module")
def tiny_input():
    """The first centerpoint_tiny test frame pair as an input sparse tensor,
    built by each package's own ``_make_input_tensor`` (stable key sort)."""
    cfg = cfg_from_yaml_file(str(CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    raw = next(iter(loader))
    rng = np.random.RandomState(0)
    feats = rng.randn(*raw["voxels"].shape[:2], 4).astype(np.float32)
    coords = raw["voxel_coords"].astype(np.int32)
    nx, ny, nz = (int(g) for g in ds.grid_size)
    shape = (nz + 1, ny, nx)
    ours = port_backbone._make_input_tensor(
        {"voxel_features": torch.from_numpy(feats),
         "voxel_coords": torch.from_numpy(coords)}, shape)
    ref = jax_backbone._make_input_tensor(
        {"voxel_features": jnp.asarray(feats),
         "voxel_coords": jnp.asarray(coords)}, shape)
    return ours, ref


def test_modules_share_one_book_per_key(tiny_input):
    """SubM layers with one indice_key build one rulebook per forward; the
    strided conv caches its output coordinates and book."""
    ours, _ = tiny_input
    g = torch.Generator().manual_seed(0)
    a = SubMConv3d(16, 16, 3, 1, 1, indice_key="res1")
    b = SubMConv3d(16, 16, 3, 1, 1, indice_key="res1")
    d = SparseConv3d(16, 32, 3, 2, 1, indice_key="spconv2")
    for m in (a, b, d):
        m.reset_parameters(g)
    cache = {}
    x = b(a(ours, cache), cache)
    y = d(x, cache)
    assert len(cache) == 2
    assert y.features.shape == (ours.capacity, 32)
    assert torch.equal(y.indices, engine.sparse_conv_downsample(ours, 3, 2, 1)[0])


def _chunk_refs(st, w, **kw):
    """(reference chunked gather, Pallas kernel in interpret mode)."""
    gidx = jax_engine.subm_gather_indices(st, 3)
    cidx = jax_engine.chunk_anchor_code(gidx, st.capacity)
    nx = int(st.spatial_shape[-1])
    ref = jax_engine.gather_conv_chunked(st.features, st.keys(),
                                         st.indices[:, -1], nx, cidx, w, **kw)
    pal = pallas_conv.gather_conv_chunked_fast(
        st.features, st.keys(), st.indices[:, -1], nx, cidx, w, bm=64, s=128,
        interpret=True, force_kernel=True, **kw)
    return np.asarray(ref), np.asarray(pal)


# the backbone's real stage widths (16 -> 32, 32 -> 64) beside the narrow ones
WIDE_CASES = [(3, 300, 384, 16, 32), (4, 300, 384, 32, 64)]


def test_gather_conv_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.zeros(8, 16)
    book = torch.zeros(4, 27, dtype=torch.int32)
    w = torch.zeros(27, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_conv.gather_conv_cuda(f, book, w)
    with pytest.raises(ValueError, match="unknown impl"):
        gather_conv.sparse_gather_conv(f, book, w, impl="xla")
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_conv.gather_conv_requant_cuda(
            f.to(torch.int8), book, w.to(torch.int8), torch.ones(16),
            torch.ones(16), torch.zeros(16), torch.tensor(0.1))
    with pytest.raises(ValueError, match="unknown impl"):
        gather_conv.sparse_gather_conv_requant(
            f.to(torch.int8), book, w.to(torch.int8), torch.ones(16),
            torch.ones(16), torch.zeros(16), torch.tensor(0.1), impl="xla")
