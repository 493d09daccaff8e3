"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library and bound with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Sources may
include the package's own ``csrc/*.cuh`` headers.  Builds happen at first
use, from the sources in the checkout, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``).  A library's file name carries
a hash of its source, the headers and the flags, so an edited source is
never served by a stale build.  :func:`build` starts one ``nvcc`` per source,
all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "HEADERS", "BUILD_DIR", "build", "load", "build_log"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: kernel name -> its source under the package
SOURCES = {
    "paged_attention": _PKG / "csrc" / "paged_attention.cu",
    "flash_fwd": _PKG / "csrc" / "flash_fwd.cu",
    "flash_bwd_dq": _PKG / "csrc" / "flash_bwd_dq.cu",
    "flash_bwd_dkv": _PKG / "csrc" / "flash_bwd_dkv.cu",
    "reduce_stacked": _PKG / "csrc" / "reduce_stacked.cu",
    "copy": _PKG / "csrc" / "copy.cu",
}
#: headers the sources include; part of every build's hash
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of each entry point: (function name, argtypes)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "paged_attention": (
        "ft_paged_attention_decode",
        [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    ),
    "flash_fwd": ("ft_flash_fwd", [_P] * 5 + [_I] * 5 + [_F] + [_I] * 4 + [_P]),
    "flash_bwd_dq": (
        "ft_flash_bwd_dq",
        [_P] * 8 + [_I] * 5 + [_F] * 2 + [_I] * 4 + [_P],
    ),
    "flash_bwd_dkv": (
        "ft_flash_bwd_dkv",
        [_P] * 9 + [_I] * 5 + [_F] * 2 + [_I] * 4 + [_P],
    ),
    "reduce_stacked": ("ft_reduce_stacked", [_P, _P, _I, _L, _I, _I, _I, _P]),
    "copy": ("ft_copy", [_P, _P, _L, _P]),
}

_loaded: dict = {}
#: name -> {"seconds": build wall time, "ptxas": compiler report}
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel (default: all) that has no current
    build, one ``nvcc`` per source started together.  Returns ``{name:
    library path}``; raises with the compiler's output on any failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, paths[n])
        build_log[n] = {"seconds": time.monotonic() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    its entry point's ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
