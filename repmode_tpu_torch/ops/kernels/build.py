"""Build and load the port's hand-written CUDA kernels.

Each source under ``repmode_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. That keeps a build to seconds: no PyTorch headers
are compiled. Libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of their source, the local headers it includes
and the flags, so an edited source or header is rebuilt and an unchanged
one is reused. Nothing is built when this module is
imported; the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel name -> source file in csrc/
SOURCES: Dict[str, str] = {
    "conv3d_same": "conv3d_same.cu",
    "conv3d_persample": "conv3d_persample.cu",
    "conv3d_dw_persample": "conv3d_dw_persample.cu",
    "conv3d_dpad": "conv3d_dpad.cu",
    "conv3d_tapconcat": "conv3d_tapconcat.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled on first use and "
        "need the CUDA toolkit (nvcc on PATH or under /usr/local/cuda/bin)"
    )


def source_files(name: str) -> list:
    """The source of one kernel and every local header it includes
    (``#include "..."``, followed through the headers)."""
    files, todo = [], [CSRC / SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(), re.M):
            todo.append(path.parent / inc)
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, ptxas_verbose: bool) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile the named kernels (all by default), one nvcc each, in parallel.

    Returns {name: {"seconds": wall time, "log": nvcc output, "cached": bool}}.
    Raises RuntimeError if any compile fails.
    """
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    procs = {name: _start(name, ptxas_verbose) for name in names}
    report = {}
    failed = []
    for name, proc in procs.items():
        if proc is None:
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        log, _ = proc.communicate()
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log, "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _declare(name, lib)
            _LOADED[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "conv3d_same":
        lib.conv3d_same_plan.argtypes = [i32] * 18 + [ctypes.POINTER(i32)]
        lib.conv3d_same_plan.restype = i32
        lib.conv3d_same_bf16.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 19 + [ptr]
        lib.conv3d_same_bf16.restype = i32
    elif name == "conv3d_persample":
        lib.conv3d_persample_plan.argtypes = [i32] * 18 + [ctypes.POINTER(i32)]
        lib.conv3d_persample_plan.restype = i32
        lib.conv3d_persample_bf16.argtypes = [ptr, ptr, ptr] + [i32] * 18 + [ptr]
        lib.conv3d_persample_bf16.restype = i32
    elif name == "conv3d_dw_persample":
        lib.conv3d_dw_persample_plan.argtypes = [i32] * 10 + [ctypes.POINTER(i32)]
        lib.conv3d_dw_persample_plan.restype = i32
        lib.conv3d_dw_persample_bf16.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 11 + [ptr]
        lib.conv3d_dw_persample_bf16.restype = i32
        lib.conv3d_dw_persample_wgmma_unit.argtypes = [ptr, ptr, ptr] + [i32] * 3 + [ptr]
        lib.conv3d_dw_persample_wgmma_unit.restype = i32
    elif name == "conv3d_dpad":
        lib.conv3d_dpad_plan.argtypes = [i32] * 13 + [ctypes.POINTER(i32)]
        lib.conv3d_dpad_plan.restype = i32
        lib.conv3d_dpad_bf16.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 14 + [ptr]
        lib.conv3d_dpad_bf16.restype = i32
    elif name == "conv3d_tapconcat":
        lib.conv3d_tapconcat_bf16.argtypes = [ptr, ptr, ptr] + [i32] * 6 + [ptr]
        lib.conv3d_tapconcat_bf16.restype = i32
    else:
        raise KeyError(f"no C interface declared for kernel {name!r}")
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [i32]
    err_fn.restype = ctypes.c_char_p
