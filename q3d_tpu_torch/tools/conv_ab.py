"""Kernel 1 from two sources, timed in turns on one card.

    python -m q3d_tpu_torch.tools.conv_ab --baseline OTHER/sparse_gather_conv.cu

Builds ``csrc/sparse_gather_conv.cu`` and the ``--baseline`` source (another
revision of the same file, with the same C interface), each library apart
so that its build seconds are its own, and runs both on the real inputs of
centerpoint_ref's 21 sparse convs: its first request (batch 2), seeded
weights, each BN's statistics from its input, f32 with TF32 off; each
conv's features, book, weights and row mask, in f32, in bf16 and in s8
(features per tensor, weights per output channel, symmetric).  The two
builds' outputs must be bit-equal; then each build's median CUDA-event time
(L2 flushed before each launch) is taken in the order baseline, current,
current, baseline, and one JSON line per conv and dtype gives the four
medians (of ``nms_ab.REPS`` launches each), a last line the sums.  The
convs' widths (16-128) are ones every revision has.  Needs the card.
"""

import argparse
import json
import time
from pathlib import Path

import torch

from ..ops.kernel_build import CudaLibrary, build_all
from ..ops.spconv import gather_conv
from .nms_ab import _median_ms

ROOT = Path(__file__).resolve().parents[2]
REF_CFG = ROOT / "tools" / "cfgs" / "synthetic_models" / "centerpoint_ref.yaml"
ORDER = ("baseline", "current", "current", "baseline")


def _ref_convs(dev):
    """centerpoint_ref's first request through the seeded model, every
    sparse conv's (name, features, book, weight, row mask) recorded."""
    from ..config import EDict, cfg_from_yaml_file
    from ..datasets import build_dataloader
    from ..models import build_network, load_data_to_device
    from ..ops.spconv import engine
    from ..ops.spconv.modules import _SparseConv, _SparseConvBase
    from ..utils.bn_calibration import calibrate_bns
    cfg = cfg_from_yaml_file(str(REF_CFG), EDict())
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size=2, training=False)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=dev)
    batch = load_data_to_device(next(iter(loader)), device=dev)
    calibrate_bns(model, batch)
    names = {m: n for n, m in model.named_modules()}
    convs = []

    def record(mod, args, out):
        st = args[0]
        if isinstance(mod, _SparseConv):
            out_idx, idx, _ = engine.sparse_conv_downsample(
                st, mod.kernel_size, mod.stride, mod.padding,
                args[2] if len(args) > 2 else None)
            valid = out_idx[:, 0] >= 0
        else:
            idx, valid = engine.subm_gather_indices(st, mod.kernel_size,
                                                    mod.dilation), st.valid
        convs.append((names[mod], st.features, idx, mod.weight.detach(),
                      valid))
    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, _SparseConvBase)]
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    return convs


def _symmetric_s8(x, axis=None):
    amax = x.abs().amax() if axis is None else x.abs().amax(
        dim=tuple(range(x.dim() - 1)))
    s = (amax / 127.0).clamp(min=1e-8)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def _launcher(lib, f, idx, w, valid):
    out = torch.empty((idx.shape[0], w.shape[2]), device=f.device,
                      dtype=torch.float32 if f.dtype == torch.int8
                      else f.dtype)
    entry = f"q3d_sparse_gather_conv_{gather_conv._SUFFIX[f.dtype]}"

    def run():
        lib.call(entry, f.data_ptr(), idx.data_ptr(), w.data_ptr(), None,
                 valid.data_ptr(), out.data_ptr(), f.shape[0], idx.shape[0],
                 idx.shape[1], f.shape[1], w.shape[2],
                 torch.cuda.current_stream().cuda_stream)
        return out
    return run


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", required=True,
                        help="another revision of csrc/sparse_gather_conv.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv_ab times the card's kernels: CUDA is needed")
    dev = torch.device("cuda")
    current = gather_conv.KERNEL
    base = CudaLibrary(current.source.name, current.signatures,
                       current.variants)
    base.source = Path(args.baseline).resolve()
    libs = {"baseline": base, "current": current}
    build_s = {tag: build_all([lib]) for tag, lib in libs.items()}
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"build_s": build_s, "card": card}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    convs = _ref_convs(dev)
    scratch = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()
    sums = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for name, feats, idx, w32, valid in convs:
            for tag in ("f32", "bf16", "s8"):
                if tag == "s8":
                    f, w = _symmetric_s8(feats.float()), _symmetric_s8(
                        w32.float(), axis=-1)
                else:
                    dt = torch.float32 if tag == "f32" else torch.bfloat16
                    f, w = feats.to(dt).contiguous(), w32.to(dt).contiguous()
                runs = {k: _launcher(lib, f, idx, w, valid)
                        for k, lib in libs.items()}
                outs = {k: run().clone() for k, run in runs.items()}
                torch.cuda.synchronize()
                if not torch.equal(outs["baseline"], outs["current"]):
                    raise AssertionError(f"{name} {tag}: the two builds' "
                                         f"outputs differ")
                ms = [_median_ms(runs[k], flush) for k in ORDER]
                print(json.dumps({"conv": name, "dtype": tag,
                                  "Cin": f.shape[1], "Cout": w.shape[2],
                                  "K": idx.shape[1], "M": idx.shape[0],
                                  "order": list(ORDER), "ms": ms}),
                      flush=True)
                for k, v in zip(ORDER, ms):
                    sums.setdefault(tag, {}).setdefault(k, 0.0)
                    sums[tag][k] += v / 2
    print(json.dumps({"sums_ms": sums, "convs": len(convs), "card": card,
                      "equal": "outputs bit-equal on every conv",
                      "run_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
