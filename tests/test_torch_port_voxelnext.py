"""PyTorch port vs the JAX package: VoxelNeXt, tiny (``voxelnext_tiny.yaml``),
f32, batch 2.

MeanVFE -> VoxelResBackBone8xVoxelNeXt (30 3D sparse convs, the x2 / x4
upscale and merge, ``bev_sum_pool``, the 2D conv_out and shared_conv) ->
VoxelNeXtHead (2 heads x 5 branches: a 3x3 SubMConv2d, BN, ReLU, then a
1x1 output conv) -> the top-K decode from the voxel rows -> one NMS, on the
reference's seeded weights with every BN's statistics set from the batch
(``torch_port_anchor_common.build``).  Tolerances: the 2D convs and the 1x1
route fed one input tensor within 1e-5 of their largest output, books and
coordinates equal as integer tables, ``bev_sum_pool``'s keys equal and its
sums within 1e-6; the whole model's encoded rows and every branch output
within 1e-4 of their largest magnitude, the detections slot for slot
(valid and labels equal, boxes and scores within 1e-4 + 1e-4 relative, as
``test_torch_port_centerpoint.py`` holds them, but the heading within 1e-3
rad: it is atan2 of the rot branch's two outputs, which divides their f32
differences by the length of that vector, short on these random weights;
measured 4.3e-4 on one of 128 detections, the other columns 1e-5).

A fault of the reference, not copied (``ROADMAP.md`` §3): its sparse convs
cache the key->row probe table of the chunked rulebook builder by spatial
shape alone (``q3d_tpu/ops/spconv/modules.py::_get_probe``), and
VoxelNeXt's conv_out is a stride-1 ``SparseConv2d`` whose output set (the
dilation of its input) has its input's spatial shape, so the reference's
shared_conv builds its book from conv_out's INPUT table and gathers rows
that are not its taps.  The port builds each book from its own input.  The
comparisons run the reference with the cache keyed per tensor (the probe
built for each coordinate set, the rest of the package as it is);
``test_reference_shared_conv_reads_a_stale_probe`` pins the fault.
"""

import contextlib
from unittest import mock

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from q3d_tpu.models.backbones_3d import spconv_backbone_voxelnext as jvn
from q3d_tpu.models.dense_heads import voxelnext_head as jvh
from q3d_tpu.ops.spconv import SparseConvTensor as JaxSparseConvTensor
from q3d_tpu.ops.spconv import engine as jengine
from q3d_tpu.ops.spconv import modules as jmodules
from q3d_tpu.utils.pcdet_names import export_torch_state_dict

import torch_port_anchor_common as common
import torch_port_quant_common as qcommon
from q3d_tpu_torch.models.backbones_3d import spconv_backbone_voxelnext as pvn
from q3d_tpu_torch.models.dense_heads import voxelnext_head as pvh
from q3d_tpu_torch.ops.spconv import engine as pengine
from q3d_tpu_torch.ops.spconv import modules as pmodules
from q3d_tpu_torch.utils.checkpoint import import_torch_state_dict
from q3d_tpu_torch.utils.weights import (pcdet_name, reference_module_path,
                                         state_dict_from_jax)
from torch_port_jax_cache import jax_compile_cache  # noqa: F401

torch.set_num_threads(2)
CONV_RTOL = 1e-5
MAP_RTOL = 1e-4
DET_TOL = 1e-4
HEADING_TOL = 1e-3
OUT_KEYS = ("final_boxes", "final_scores", "final_labels", "final_valid")


@contextlib.contextmanager
def fresh_probes():
    """The reference with its probe table built for each coordinate set,
    not cached by spatial shape (see the module docstring)."""
    with mock.patch.object(jmodules, "_get_probe",
                           lambda st, cache: jengine.build_probe_stack(st)):
        yield


def reference_forward(ref, model=None, batch=None):
    """One jitted reference forward -> (final outputs, {path: output} of the
    2D conv blocks and the head's branches, ``bev_sum_pool``'s (input,
    output) as recorded arrays)."""
    recorded = (jvn._Sparse2dConvBNReLU, jvh.SparseSeparateHead)
    real_pool = jvn.bev_sum_pool

    def apply(v, b):
        store, pool = {}, []

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            mod = context.module
            if context.method_name == "__call__" \
                    and isinstance(mod, recorded):
                store[".".join(str(p) for p in mod.path)] = out
            return out

        def record_pool(st, *a, **kw):
            out = real_pool(st, *a, **kw)
            pool.append((st, out))
            return out
        with fnn.intercept_methods(interceptor), \
                mock.patch.object(jvn, "bev_sum_pool", record_pool):
            out = (model or ref["model"]).apply(v, b, train=False)
        return {k: out[k] for k in OUT_KEYS}, store, pool[0]

    out, store, pool = jax.jit(apply)(ref["vars"], batch or ref["batch"])
    layers = {p: (jax.tree_util.tree_map(np.asarray, o) if isinstance(o, dict)
                  else qcommon._arrays(o)) for p, o in store.items()}
    return ({k: np.asarray(v) for k, v in out.items()}, layers,
            tuple(qcommon._arrays(x) for x in pool))


def port_forward(model, batch):
    """-> (final outputs, {module name: output} of the 2D conv blocks and
    the head's branches)."""
    names = {m: n for n, m in model.named_modules()}
    layers = {}

    def hook(mod, args, out):
        layers[names[mod]] = out
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (pvn._Sparse2dConvBNReLU,
                               pvh.SparseSeparateHead))]
    try:
        with torch.no_grad():
            out = model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return {k: out[k].numpy() for k in OUT_KEYS}, layers


def check_detections(ours, theirs):
    """Slot for slot: valid and labels equal, boxes but their heading and
    scores within DET_TOL (absolute and relative), the heading within
    HEADING_TOL."""
    valid = theirs["final_valid"]
    np.testing.assert_array_equal(ours["final_valid"], valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(ours["final_labels"][valid],
                                  theirs["final_labels"][valid])
    ob, tb = ours["final_boxes"][valid], theirs["final_boxes"][valid]
    np.testing.assert_allclose(ob[:, :6], tb[:, :6], rtol=DET_TOL,
                               atol=DET_TOL)
    np.testing.assert_allclose(ob[:, 6], tb[:, 6], rtol=0, atol=HEADING_TOL)
    np.testing.assert_allclose(ours["final_scores"][valid],
                               theirs["final_scores"][valid], rtol=DET_TOL,
                               atol=DET_TOL)


def rel_err(ours, theirs):
    scale = float(np.abs(theirs).max())
    assert scale > 1e-2, scale                         # a signal, not zeros
    return float(np.abs(np.asarray(ours) - theirs).max()) / scale


def jax_st(rec):
    return JaxSparseConvTensor(
        features=rec["features"], indices=rec["indices"],
        spatial_shape=rec["spatial_shape"], batch_size=rec["batch_size"],
        sorted_rows=True)


def first_frame(batch):
    """The batch's first frame as a batch of one."""
    b = batch["batch_size"]
    return {k: v[:1] if getattr(v, "shape", ())[:1] == (b,) else v
            for k, v in {**batch, "batch_size": 1}.items()}


@pytest.fixture(scope="module")
def vn():
    ref = common.build("voxelnext_tiny")
    with fresh_probes():
        jout, jlayers, jpool = reference_forward(ref)
    out, layers = port_forward(ref["port"], ref["port_batch"])
    return ref, jout, jlayers, jpool, out, layers


def test_2d_convs_and_pointwise_route_match_reference(vn):
    """On the reference's own merged tensor: ``bev_sum_pool`` (keys exact,
    sums within 1e-6); the 2D books and conv_out's output coordinates at
    stride 1 and 2 equal; SubMConv2d, SparseConv2d (stride 1 and 2) and the
    1x1 SubM conv within 1e-5 of their largest output, the last on the
    pointwise route, chosen before any book is built."""
    ref, _, _, (merged, pooled), _, _ = vn
    ours = pvn.bev_sum_pool(qcommon._st(merged))
    np.testing.assert_array_equal(ours.indices.numpy(), pooled["indices"])
    assert rel_err(ours.features.numpy(), pooled["features"]) <= 1e-6
    assert (pooled["indices"][:, 0] >= 0).sum() > 100

    jst, pst = jax_st(pooled), qcommon._st(pooled)
    rng = np.random.RandomState(0)
    cin = pst.num_channels
    cases = []
    for cls, jcls, ks, stride, cout in (
            (pmodules.SubMConv2d, jmodules.SubMConv2d, 3, 1, 32),
            (pmodules.SparseConv2d, jmodules.SparseConv2d, 3, 1, 32),
            (pmodules.SparseConv2d, jmodules.SparseConv2d, 3, 2, 16),
            (pmodules.SubMConv2d, jmodules.SubMConv2d, 1, 1, 3)):
        pad = ks // 2
        conv = cls(cin, cout, ks, stride, pad, bias=True)
        w = rng.uniform(-0.1, 0.1, conv.weight.shape).astype(np.float32)
        b = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(b))
        cases.append((conv, jcls(cout, ks, stride, pad, use_bias=True),
                      {"params": {"weight": w, "bias": b}}))

    def reference(t, params):
        """The reference's books and convs, in one jitted call."""
        books = [jengine.subm_gather_indices(t, 3)] + [
            jengine.sparse_conv_downsample(t, 3, stride, 1)
            for stride in (1, 2)]
        return books, [jmod.apply(p, t, {}).features
                       for (_, jmod, _), p in zip(cases, params)]
    books, wants = jax.tree_util.tree_map(np.asarray, jax.jit(reference)(
        jst, [p for _, _, p in cases]))
    np.testing.assert_array_equal(
        pengine.subm_gather_indices(pst, 3).numpy(), books[0])
    for stride, (jo, jb, jsp) in zip((1, 2), books[1:]):
        po, pb, psp = pengine.sparse_conv_downsample(pst, 3, stride, 1)
        assert psp == tuple(int(x) for x in jsp)
        np.testing.assert_array_equal(po.numpy(), jo)
        np.testing.assert_array_equal(pb.numpy(), jb)
    for (conv, _, _), want in zip(cases, wants):
        ks, stride = conv.kernel_size[0], conv.stride
        calls = sum(pmodules.POINTWISE_CALLS.values())
        cache = {}
        with torch.no_grad():
            got = conv(pst, cache).features.numpy()
        assert got.shape == want.shape
        assert rel_err(got, want) <= CONV_RTOL, (type(conv).__name__, ks,
                                                 stride)
        pointwise = ks == 1
        assert conv.pointwise == pointwise and (not cache) == pointwise
        assert sum(pmodules.POINTWISE_CALLS.values()) == calls + pointwise


def test_voxelnext_matches_reference(vn):
    """The whole tiny model in f32: the encoded rows (shared_conv's output)
    and every branch of both heads within 1e-4 of their largest magnitude,
    the detections slot for slot; 42 convs on kernel 1's route, 10 on the
    pointwise one."""
    ref, jout, jlayers, _, out, layers = vn
    enc, jenc = layers["backbone_3d.shared_conv"], \
        jlayers["backbone_3d.shared_conv"]
    np.testing.assert_array_equal(enc.indices.numpy(), jenc["indices"])
    assert rel_err(enc.features.numpy(), jenc["features"]) <= MAP_RTOL
    for h in range(2):
        for key, val in layers[f"dense_head.heads_list.{h}"].items():
            theirs = jlayers[f"dense_head.heads_list_{h}"][key]
            assert rel_err(val.numpy(), theirs) <= MAP_RTOL, (h, key)
    check_detections(out, jout)
    convs = [m for m in ref["port"].modules()
             if isinstance(m, pmodules._SparseConvBase)]
    assert sum(not m.pointwise for m in convs) == 42
    assert sum(m.pointwise for m in convs) == 10


def test_reference_shared_conv_reads_a_stale_probe(vn):
    """The fault the port does not copy.  The reference's own conv_out and
    shared_conv blocks, applied to the reference's pooled BEV tensor in
    turn with one rulebook cache, as its backbone applies them: conv_out's
    input and output sets share one spatial shape, hence one probe-cache
    key, while they differ as coordinate sets; conv_out's output is the
    same with a cache or without, shared_conv's is not, and the port's
    shared_conv, like the whole model's comparison above, is the one built
    on its own input's table."""
    ref, _, jlayers, (_, pooled), _, layers = vn
    params = ref["vars"]["params"]["backbone_3d"]
    stats = ref["vars"]["batch_stats"]["backbone_3d"]
    out_ch = params["shared_conv"]["conv"]["weight"].shape[-1]
    blocks = [(jvn._Sparse2dConvBNReLU(out_ch, 3, 1, 1, "spconv"), "conv_out"),
              (jvn._Sparse2dConvBNReLU(out_ch, 3, 1, 1, "subm", use_bias=True),
               "shared_conv")]
    def run(st, shared):
        cache, outs = {}, {}
        for mod, name in blocks:
            st = mod.apply({"params": params[name],
                            "batch_stats": stats[name]}, st,
                           cache if shared else {})
            outs[name] = {"features": st.features, "indices": st.indices}
        return outs
    stale, fresh = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda st: (run(st, True), run(st, False)))(jax_st(pooled)))
    co = fresh["conv_out"]
    assert (co["indices"][:, 0] >= 0).sum() > (pooled["indices"][:, 0]
                                               >= 0).sum()
    for key in ("features", "indices"):
        np.testing.assert_array_equal(stale["conv_out"][key], co[key])
    np.testing.assert_array_equal(fresh["shared_conv"]["indices"],
                                  jlayers["backbone_3d.shared_conv"]["indices"])
    sc = fresh["shared_conv"]["features"]
    assert rel_err(stale["shared_conv"]["features"], sc) > 0.1
    assert rel_err(jlayers["backbone_3d.shared_conv"]["features"], sc) <= 1e-6
    ours = layers["backbone_3d.shared_conv"].features.numpy()
    assert rel_err(ours, sc) <= MAP_RTOL


def test_double_flip_matches_reference(vn):
    """``_merge_double_flip`` on exactly mirrored rows (as
    ``tests/test_voxelnext_e2e.py`` builds them) gives the original rows,
    each cell once, as the reference's does; the whole double-flip forward
    (the first frame, 1 -> 4) gives the reference's detections slot for
    slot."""
    rng = np.random.RandomState(0)
    h = w = 8
    n = 5
    y0, x0 = rng.randint(0, h, n), rng.randint(0, w, n)
    pred0 = {"hm": rng.rand(n, 2), "center": rng.rand(n, 2),
             "center_z": rng.randn(n, 1), "dim": rng.randn(n, 3),
             "rot": rng.randn(n, 2), "vel": rng.randn(n, 2)}
    pred0 = {k: v.astype(np.float32) for k, v in pred0.items()}
    rows, preds = [], []
    for i, (fx, fy) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        p = {k: v.copy() for k, v in pred0.items()}
        for axis, flipped in ((0, fx), (1, fy)):
            if flipped:
                p["center"][:, axis] = 1.0 - p["center"][:, axis]
                p["rot"][:, axis] *= -1
                p["vel"][:, axis] *= -1
        rows.append(np.stack([np.full(n, i), h - 1 - y0 if fy else y0,
                              w - 1 - x0 if fx else x0], 1))
        preds.append(p)
    indices = np.concatenate(rows).astype(np.int32)
    pred = {k: np.concatenate([p[k] for p in preds]) for k in pred0}
    pred["hm"] = np.log(pred["hm"] / (1 - pred["hm"]))
    theirs = jax.jit(lambda p, i: jvh.VoxelNeXtHead._merge_double_flip(
        None, p, JaxSparseConvTensor(
            features=np.zeros((4 * n, 1), np.float32), indices=i,
            spatial_shape=(h, w), batch_size=4)))(pred, indices)
    ours = ref_head = vn[0]["port"].dense_head
    ours = ref_head._merge_double_flip(
        {k: torch.from_numpy(v) for k, v in pred.items()},
        qcommon._st({"features": np.zeros((4 * n, 1), np.float32),
                     "indices": indices, "spatial_shape": (h, w),
                     "batch_size": 4, "feat_scale": None}))
    m_valid = ours[3].numpy()
    np.testing.assert_array_equal(m_valid, np.asarray(theirs[3]))
    assert m_valid.sum() == len(np.unique(y0 * w + x0))
    for a, b in zip(ours[1:3], theirs[1:3]):
        np.testing.assert_array_equal(a.numpy()[m_valid], np.asarray(b)[m_valid])
    got_xy = ours[1].numpy()[m_valid]
    for key in pred0:
        np.testing.assert_allclose(ours[0][key].numpy()[m_valid],
                                   np.asarray(theirs[0][key])[m_valid],
                                   rtol=1e-6, atol=1e-6)
        want = np.exp(pred0[key]) if key == "dim" else pred0[key]
        for j in range(n):
            row = np.flatnonzero((got_xy[:, 0] == x0[j])
                                 & (got_xy[:, 1] == y0[j]))[0]
            np.testing.assert_allclose(ours[0][key].numpy()[m_valid][row],
                                       want[j], rtol=1e-5, atol=1e-5)

    ref = vn[0]
    jcfg, pcfg = common.configs("voxelnext_tiny")
    for cfg in (jcfg, pcfg):
        cfg.MODEL.DENSE_HEAD.DOUBLE_FLIP = True
    from q3d_tpu.models import build_network as jax_build_network
    from q3d_tpu_torch.models import build_network
    jmodel = jax_build_network(jcfg.MODEL, num_class=len(jcfg.CLASS_NAMES),
                               dataset=ref["model"].dataset)
    with fresh_probes():
        jout, _, _ = reference_forward(ref, model=jmodel,
                                       batch=first_frame(ref["batch"]))
    port = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES),
                         ref["port"].dataset, device="cpu")
    port.load_state_dict(ref["port"].state_dict())
    out, _ = port_forward(port, first_frame(ref["port_batch"]))
    assert out["final_boxes"].shape == (1, 64, 7)
    check_detections(out, jout)


def test_voxelnext_weights_and_paths(vn):
    """Every VoxelNeXt conv's port name and the reference's module path map
    onto each other (``reference_module_path`` and the state-dict naming);
    pcdet's 2D sparse layout (O, kh, kw, I) (the reference exporter's for
    every 2D weight it names) and spconv1's (kh, kw, I, O) import into the
    kernel's (K, Cin, Cout); the 1x1 convs' (O, 1, 1, 1, I) too."""
    ref = vn[0]
    port = ref["port"]
    state = port.state_dict()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v
    walk(ref["vars"]["params"], ("params",))
    out_index = lambda head, branch: 1                         # noqa: E731
    convs = [(n, m) for n, m in port.named_modules()
             if isinstance(m, pmodules._SparseConvBase)]
    assert len(convs) == 52
    for name, mod in convs:
        path = reference_module_path(name)
        leaf = ("params", *path.split("."), "weight")
        assert leaf in flat, (name, path)
        assert pcdet_name(leaf, out_index) == f"{name}.weight"
        nd = 2 if path.startswith(("backbone_3d.conv_out",
                                   "backbone_3d.shared_conv",
                                   "dense_head.")) else 3
        assert mod.QUANT_KIND == \
            f"{'subm' if mod.SUBM else 'sparse'}_conv{nd}d", name
    assert reference_module_path("backbone_3d.shared_conv.0") \
        == "backbone_3d.shared_conv.conv"
    assert reference_module_path("dense_head.heads_list.1.hm.1") \
        == "dense_head.heads_list_1.hm_out"

    exported, _ = export_torch_state_dict(ref["vars"])
    spconv2, spconv1 = {}, {}
    for key, t in state.items():
        if key.endswith(".weight") and t.dim() == 3:
            k, i, o = t.shape
            ks = {27: (3, 3, 3), 9: (3, 3), 1: (1, 1, 1)}[k]
            spconv2[key] = t.permute(2, 0, 1).reshape(o, *ks, i)
            spconv1[key] = t.reshape(*ks, i, o)
            if key in exported:
                np.testing.assert_array_equal(spconv2[key].numpy(),
                                              exported[key], err_msg=key)
        else:
            spconv2[key] = spconv1[key] = t
    assert any(v.dim() == 4 for v in spconv2.values())
    for pth in (spconv2, spconv1):
        loaded = import_torch_state_dict(pth, port, strict=True)
        for key, t in state.items():
            assert torch.equal(loaded[key], t), key
    assert torch.equal(state_dict_from_jax(ref["vars"])[
        "backbone_3d.shared_conv.0.bias"], state["backbone_3d.shared_conv.0.bias"])
