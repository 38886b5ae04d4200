"""Checkpoints in the reference's layout (``repro/train/checkpoint.py``):
a directory with ``manifest.msgpack`` (``{"step": int, "leaves": {key:
{"file", "shape", "dtype"}}}``, keys the leaves' paths joined by ``/`` in
sorted-key order) and one raw ``.bin`` of each leaf's bytes, the key's
``/`` written as ``__``. A directory that either package writes restores
in the other.

The machine with the card has no ``msgpack`` package, so the manifest goes
through a codec of its own (``packb``, ``unpackb``) for the types a
manifest holds: map, str, int, list, nil (and bool). It writes the bytes
``msgpack.packb`` writes: the smallest encoding of each value, strings as
the str type.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import torch

from repro_torch.train import tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32, "int64": torch.int64}
NAMES = {v: k for k, v in DTYPES.items()}


# --------------------------------------------------------------------------- #
# msgpack, for a manifest's types
# --------------------------------------------------------------------------- #

def _pack_len(n: int, fix: int, fix_max: int, codes) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is False or obj is True:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _pack_len(len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out += _pack_len(len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out += _pack_len(len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _unpack(data: bytes, i: int):
    """(object, next offset) of the value at ``data[i]``."""
    c = data[i]
    i += 1

    def take(fmt):
        return struct.unpack_from(fmt, data, i)[0], i + struct.calcsize(fmt)

    def items(n, i, pairs):
        out = []
        for _ in range(n * (2 if pairs else 1)):
            x, i = _unpack(data, i)
            out.append(x)
        return (dict(zip(out[::2], out[1::2])) if pairs else out), i

    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c < 0xC0 or c in _STR:
        n, i = (c & 0x1F, i) if c < 0xC0 else take(_STR[c])
        return data[i:i + n].decode("utf-8"), i + n
    if 0x90 <= c < 0xA0 or c in _ARRAY:
        n, i = (c & 0x0F, i) if c < 0xA0 else take(_ARRAY[c])
        return items(n, i, False)
    if 0x80 <= c < 0x90 or c in _MAP:
        n, i = (c & 0x0F, i) if c < 0x90 else take(_MAP[c])
        return items(n, i, True)
    if c in _FIXED:
        return take(_FIXED[c])
    if c in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[c], i
    raise ValueError(f"msgpack: type byte {c:#x} is not one a manifest holds")


def unpackb(data: bytes):
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} bytes after the value")
    return obj


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #

def save_checkpoint(path: str, params, step: int = 0) -> None:
    """Write each leaf's bytes, one leaf at a time, then the manifest."""
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in tree.items(params):
        t = leaf.detach().contiguous().cpu()
        fname = key.replace("/", "__") + ".bin"
        manifest["leaves"][key] = {"file": fname, "shape": list(t.shape),
                                   "dtype": NAMES[t.dtype]}
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        with open(os.path.join(path, fname), "wb") as f:
            f.write(raw.numpy().tobytes())
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))


def restore_checkpoint(path: str, like_tree) -> Tuple[Any, int]:
    """Restore into the structure of ``like_tree`` (each leaf on its like
    leaf's device, in the dtype and shape the checkpoint holds)."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    like = dict(tree.items(like_tree))
    if set(manifest["leaves"]) != set(like):
        raise ValueError("checkpoint/tree structure mismatch: "
                         f"{sorted(set(like) ^ set(manifest['leaves']))}")
    restored = []
    for key, leaf in like.items():
        meta = manifest["leaves"][key]
        with open(os.path.join(path, meta["file"]), "rb") as f:
            raw = bytearray(f.read())
        dtype = DTYPES[meta["dtype"]]
        t = (torch.frombuffer(raw, dtype=dtype) if raw
             else torch.empty(0, dtype=dtype)).reshape(meta["shape"])
        restored.append(t.to(leaf.device))
    return tree.unflatten(like_tree, restored), manifest["step"]
