"""Read the reference's native checkpoints without JAX, flax or msgpack.

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
"""

import io
import pickle
import struct

import numpy as np


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
