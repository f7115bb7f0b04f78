"""Checkpoints: the port's own, written and read as pcdet's ``.pth``, and,
without JAX, flax or msgpack, the reference's native ones.

``save_checkpoint`` writes pcdet's layout (``train_utils.py:221``
checkpoint_state) with ``torch.save``: ``{"model_state": <pcdet-named
state_dict>, "optimizer_state", "epoch", "it", "version"}``, as
``checkpoint_epoch_{n}.pth``, keeping the newest ``max_keep``;
``load_checkpoint`` reads it back with ``torch.load(weights_only=True)``
and ``find_latest_checkpoint`` finds the newest readable one (port of
``q3d_tpu/utils/checkpoint.py:30-77``).  ``load_pth_file`` and
``tools/test.py --ckpt`` read them as any pcdet ``.pth``.

The reference's ``save_checkpoint`` (``q3d_tpu/utils/checkpoint.py``)
pickles a plain dict whose ``model_state`` is flax's msgpack encoding of
the variables.  ``load_flax_checkpoint`` reads it with a restricted
unpickler that refuses every class (the blob holds only dicts, bytes,
strings, numbers and None, so a pickle that asks for a class is not one of
these checkpoints and is not run) and decodes the msgpack here: flax's
ext type 1 (an ndarray as ``(shape, dtype name, C-order bytes)``) and type
3 (a numpy scalar, the same form) decode to numpy; type 2 (a complex
number) and chunked arrays raise.  ``utils.weights.state_dict_from_jax``
takes the result.

``load_pth_file`` reads a pcdet ``.pth`` with ``torch.load(...,
weights_only=True)``, whose unpickler takes tensors and plain containers and
refuses every other class, and ``import_torch_state_dict`` maps its model
state onto the port's state dict (port of
``q3d_tpu/utils/checkpoint.py:107-263``): the port's names are pcdet's, so
each key is looked up by name first, then by the longest suffix of its
module path whose tensor adapts to the port's shape (``adapt_torch_tensor``).
"""

import io
import pickle
import re
import struct
from pathlib import Path

import numpy as np
import torch

CHECKPOINT_VERSION = "q3d_tpu_torch+0.1"


def _epoch_checkpoints(ckpt_dir):
    """checkpoint_epoch_*.pth in ``ckpt_dir``, oldest first (by mtime, then
    by epoch)."""
    def key(p):
        m = re.fullmatch(r"checkpoint_epoch_(\d+)\.pth", p.name)
        return p.stat().st_mtime, int(m.group(1)) if m else -1
    return sorted(Path(ckpt_dir).glob("checkpoint_epoch_*.pth"), key=key)


def save_checkpoint(path, model, optimizer=None, epoch=0, it=0,
                    max_keep=None):
    """Write ``model``'s state dict (and ``optimizer``'s) in pcdet's layout;
    with ``max_keep``, delete the oldest epoch checkpoints beyond that many
    in the same directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state": {k: v.detach().cpu()
                                for k, v in model.state_dict().items()},
                "optimizer_state": None if optimizer is None
                else optimizer.state_dict(),
                "epoch": int(epoch), "it": int(it),
                "version": CHECKPOINT_VERSION}, path)
    if max_keep:
        for old in _epoch_checkpoints(path.parent)[:-max_keep]:
            old.unlink(missing_ok=True)
    return path


def load_checkpoint(path, model, optimizer=None):
    """Load a checkpoint of ``save_checkpoint`` into ``model`` (strictly) and
    ``optimizer`` -> (epoch, it)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model_state"], strict=True)
    if optimizer is not None and blob.get("optimizer_state") is not None:
        optimizer.load_state_dict(blob["optimizer_state"])
    return int(blob.get("epoch", 0)), int(blob.get("it", 0))


def find_latest_checkpoint(ckpt_dir):
    """The newest readable epoch checkpoint in ``ckpt_dir`` (auto-resume,
    reference tools/train.py:146-158), or None."""
    for ckpt in reversed(_epoch_checkpoints(ckpt_dir)):
        try:
            torch.load(ckpt, map_location="cpu", weights_only=True)
            return ckpt
        except (OSError, RuntimeError, pickle.UnpicklingError, EOFError):
            continue
    return None


class _NoClassUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"checkpoint asks for class {module}.{name}: not a plain "
            f"checkpoint dict, refused")


class _Reader:
    """A msgpack decoder over one bytes object (the subset flax writes:
    every type but timestamps)."""

    def __init__(self, data, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        fixed = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xc4: (">B", self.bin), 0xc5: (">H", self.bin),
                 0xc6: (">I", self.bin), 0xd9: (">B", self.str),
                 0xda: (">H", self.str), 0xdb: (">I", self.str),
                 0xdc: (">H", self.array), 0xdd: (">I", self.array),
                 0xde: (">H", self.map), 0xdf: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        ext_len = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in ext_len:
            return self.ext(self.unpack(ext_len[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def bin(self, n):
        return bytes(self.take(n))

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))


def msgpack_decode(data, ext_hook=None):
    """One msgpack value from ``data`` (all of it must be consumed)."""
    def no_ext(code, _):
        raise ValueError(f"msgpack: ext type {code} not expected here")
    r = _Reader(data, ext_hook or no_ext)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _ndarray(payload):
    shape, dtype_name, buf = msgpack_decode(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"flax ndarray of dtype {dtype_name!r} is not "
                         f"supported without JAX") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C").copy()


def _flax_ext(code, payload):
    if code == 1:                       # ndarray
        return _ndarray(payload)
    if code == 3:                       # numpy scalar
        return _ndarray(payload)[()]
    raise ValueError(f"flax msgpack ext type {code} (2 = complex) is not "
                     f"supported")


def flax_msgpack_restore(data):
    """flax ``serialization.msgpack_restore`` -> nested dicts of numpy."""
    tree = msgpack_decode(data, _flax_ext)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError("chunked flax arrays (> 1 GiB) are not "
                                 "supported")
            for v in node.values():
                check(v)
    check(tree)
    return tree


def load_flax_checkpoint(path):
    """A checkpoint of the reference's ``save_checkpoint`` -> (variables as
    nested dicts of numpy arrays, epoch, it)."""
    with open(path, "rb") as f:
        blob = _NoClassUnpickler(io.BytesIO(f.read())).load()
    if not isinstance(blob, dict) or "model_state" not in blob:
        raise ValueError(f"{path}: not a checkpoint dict")
    variables = flax_msgpack_restore(blob["model_state"])
    return variables, blob.get("epoch", 0), blob.get("it", 0)


def adapt_torch_tensor(t, target_shape):
    """A pcdet tensor -> the port's layout of ``target_shape``, or
    ValueError.  Dense convs (OIHW), transposed convs (IOHW), BN and bias
    vectors have the port's shapes already; a sparse conv weight is
    spconv2's (O, kd, kh, kw, I) or spconv1's (kd, kh, kw, I, O) (a 2D one
    (O, kh, kw, I) or (kh, kw, I, O)), which becomes the kernel's (K, Cin,
    Cout), K k0-major; a reference-shaped
    first conv (I below the port's ``MIN_INPUT_LANES``) is zero-padded on
    its input rows (the pad lanes see only zeros)."""
    a = t.detach().cpu() if isinstance(t, torch.Tensor) \
        else torch.from_numpy(np.asarray(t))
    ts = tuple(target_shape)
    if tuple(a.shape) == ts:
        return a
    if a.dim() in (4, 5) and len(ts) == 3:
        o, i = a.shape[0], a.shape[-1]
        cands = (a.reshape(o, -1, i).permute(1, 2, 0),              # spconv2
                 a.reshape(-1, *a.shape[-2:]))                       # spconv1
        for cand in cands:
            if cand.shape[0] == ts[0] and cand.shape[2] == ts[2] \
                    and cand.shape[1] <= ts[1]:
                return torch.nn.functional.pad(
                    cand, (0, 0, 0, ts[1] - cand.shape[1])).contiguous()
    raise ValueError(f"cannot adapt torch tensor {tuple(a.shape)} -> {ts}")


def import_torch_state_dict(state_dict, model, strict=False, logger=None):
    """Map a pcdet ``state_dict`` onto the port ``model``'s tensors -> a
    state dict for ``model.load_state_dict``.

    Each target key takes the pcdet tensor of the same name when it adapts
    to the target's shape, else the first unused tensor whose name ends in
    the longest suffix of the key's module path (down to the bare leaf
    name) and adapts, as the reference's partial loader matches
    (``detector3d_template.py:361-384``).  Keys matched by neither keep the
    model's value, or raise under ``strict``."""
    target = model.state_dict()
    source = {k: v for k, v in state_dict.items()
              if isinstance(v, (torch.Tensor, np.ndarray))}
    used, out, missing = set(), {}, []
    for key, leaf in target.items():
        if key in source:
            try:
                out[key] = adapt_torch_tensor(source[key], leaf.shape).to(
                    leaf.dtype)
                used.add(key)
            except ValueError:
                pass
    for key, leaf in target.items():
        if key in out:
            continue
        *mod, name = key.split(".")
        found = None
        for start in range(len(mod) + 1):
            suffix = ".".join(mod[start:] + [name])
            for tname, arr in source.items():
                if tname in used or not (tname == suffix
                                         or tname.endswith("." + suffix)):
                    continue
                try:
                    found = tname, adapt_torch_tensor(arr, leaf.shape)
                    break
                except ValueError:
                    continue
            if found:
                break
        if found:
            used.add(found[0])
            out[key] = found[1].to(leaf.dtype)
        else:
            missing.append(key)
            out[key] = leaf
    if missing and logger:
        logger.warning(f"torch import: {len(missing)} tensors kept initialized "
                       f"(first: {missing[:5]})")
    if strict and missing:
        raise KeyError(f"unmatched tensors: {missing}")
    return out


def load_pth_file(path):
    """A pcdet ``.pth`` checkpoint -> its model state (on the CPU), read
    with ``torch.load(weights_only=True)``: a pickle that asks for any other
    class than tensors and plain containers is refused, not run."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("model_state", blob) if isinstance(blob, dict) else blob


def load_params_from_file(model, path, logger=None):
    """Load a checkpoint into ``model``: a pcdet ``.pth`` through
    ``import_torch_state_dict`` (tensors it cannot match keep their values,
    with a warning, as the reference's partial loader does), or the
    reference's native checkpoint strictly."""
    from .weights import state_dict_from_jax
    if str(path).endswith(".pth"):
        state = import_torch_state_dict(load_pth_file(path), model,
                                        logger=logger)
    else:
        state = state_dict_from_jax(load_flax_checkpoint(path)[0])
    model.load_state_dict(state, strict=True)
    return model
