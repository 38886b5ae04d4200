"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded with
``ctypes``. Libraries land in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the source, the headers beside it
(``csrc/*.cuh``, which every source may include) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
An installed copy that lies in no checkout (a non-editable ``pip install``)
builds into ``$XDG_CACHE_HOME/repro_torch_kernels`` (``~/.cache`` by
default) instead, never into the interpreter's library directory.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch


def build_dir_for(module: Path) -> Path:
    """Where the libraries of this module (``.../kernels/build.py``) go."""
    root = module.parents[3]
    if module.parents[2].name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = build_dir_for(Path(__file__).resolve())
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan",
           "wkv6")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the entry points (see the extern "C" blocks in csrc/)
_SIGNATURES = {
    "flash_attention": {
        "flash_attention_launch": (
            _I, [_I, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12 + [_I] * 4 + [_P]),
        "flash_attention_train_launch": (
            _I, [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 12 + [_I] * 4 + [_P]),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": (
            _I, [_I] * 3 + [_P] * 10 + [_I] * 6 + [_L] * 15 + [_I] * 4 + [_P]),
    },
    "decode_attention": {
        "decode_attention_launch": (
            _I, [_I] + [_P] * 5 + [_I] * 7 + [_L] * 10 + [_P]),
        "decode_attention_occupancy": (_I, [_I] * 8 + [_P]),
    },
    "rglru_scan": {
        "rglru_scan_launch": (_I, [_P] * 5 + [_I] * 3 + [_L] * 7 + [_P]),
        "rglru_step_launch": (_I, [_P] * 9 + [_I] * 3 + [_L] * 4 + [_P]),
    },
    "wkv6": {
        "wkv6_launch": (_I, [_P] * 8 + [_I] * 5 + [_L] * 19 + [_P]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # nvcc's output (ptxas register/smem report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda/bin)")


def source_bytes(name: str) -> bytes:
    """``csrc/<name>.cu`` and every header beside it, the bytes a build of
    it depends on."""
    headers = sorted(CSRC.glob("*.cuh"))
    return b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *headers])


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_bytes(name) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel that is not built yet, one nvcc each, in parallel."""
    names = list(names)
    started = {n: _start(n) for n in names}
    errors = []
    for n in names:
        try:
            _finish(n, started[n])
        except RuntimeError as e:     # wait for the others before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def on_device(device: torch.device, launch: Callable[[int], int]) -> int:
    """``launch(stream)``, ``stream`` the handle of ``device``'s current
    stream, inside a ``torch.cuda.device`` guard only when ``device`` is not
    the current device: the guard costs host time on every call, and the
    recurrent steps launch once per layer and token. Every kernel wrapper
    launches through this."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


def refuse_grad(name: str, queued: str, *tensors) -> None:
    """Raise a ``RuntimeError`` where autograd would need the gradient of
    kernel ``name`` on the card: the kernel has no backward, and its output
    (a ``torch.empty`` it fills through ``ctypes``) has no ``grad_fn``, so it
    would cut the graph without a word. ``queued`` says where its backward
    stands."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel on the card ({queued}); call it under "
            "torch.no_grad() or torch.inference_mode(), or train on the CPU, where "
            "its plain version is differentiable")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _loaded[name] = lib
    return lib
