"""Exact comparison of the simulator's results across the two packages.

The port's simulator (``repro_torch.core``, ``serving``, ``workloads``,
``obs``) is a NumPy float64 copy of the reference's, so the parity tests
hold its results to tolerance 0. ``plain`` turns a result of either package
into builtins: dataclasses field by field (``dataclasses.asdict``'s walk,
tagged with the class name), enums by name, arrays by dtype, shape and
bytes, NaN by a marker, and other objects by their attributes. Two results
agree when their ``plain`` forms are ``==``: floats compared with ``==``,
arrays with ``np.array_equal`` on the same dtype.
"""
import dataclasses
import enum
import math

import numpy as np


def plain(x, skip=()):
    """Builtin form of ``x``; fields or attributes named in ``skip`` are
    left out at every depth (wall-clock fields, back-references)."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name), skip)
                 for f in dataclasses.fields(x) if f.name not in skip})
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ("ndarray", "object", x.shape, plain(x.tolist(), skip))
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return plain(x.item(), skip)
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x
    if isinstance(x, int):
        # AccountResult is an int carrying its kind and matched tokens
        extra = {k: plain(v, skip) for k, v in vars(x).items()} \
            if hasattr(x, "__dict__") else None
        return (int(x), extra) if extra else int(x)
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x
    if isinstance(x, dict):
        return {plain(k, skip): plain(v, skip) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v, skip) for v in x)
    if callable(x) and hasattr(x, "__name__"):
        return ("callable", x.__name__)
    if hasattr(x, "__dict__"):
        return (type(x).__name__,
                {k: plain(v, skip) for k, v in vars(x).items()
                 if k not in skip})
    return repr(x)


def assert_same(ref, port, skip=()):
    """``ref`` (the JAX package's) and ``port`` agree bit for bit."""
    a, b = plain(ref, skip), plain(port, skip)
    if a != b:
        raise AssertionError(first_difference(a, b))


def first_difference(a, b, path="") -> str:
    """Where two ``plain`` forms first differ."""
    if type(a) is not type(b):
        return f"{path or '.'}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, dict):
        if list(a) != list(b):
            return f"{path or '.'}: keys {list(a)} != {list(b)}"
        for k in a:
            if a[k] != b[k]:
                return first_difference(a[k], b[k], f"{path}.{k}")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path or '.'}: length {len(a)} != {len(b)}"
        for i, (u, v) in enumerate(zip(a, b)):
            if u != v:
                return first_difference(u, v, f"{path}[{i}]")
    return f"{path or '.'}: {a!r:.200} != {b!r:.200}"
