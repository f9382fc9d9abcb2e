"""ctypes loader for the port's native host ops (``patchops.cpp``).

The port's own copy of ``repmode_tpu.native``: ``crop_flip_batch`` (the
training sampler's patch batcher) and ``lzw_decode`` (TIFF-LZW subblocks of
CZI files). The library is compiled by ``g++`` at first use into
``build/native/`` at the root of the checkout, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one reused.
Nothing is built when this module is imported.

Where the JAX loader returns None when the build fails and its callers
quietly take numpy, this loader raises with the compiler's output whenever
the native path is asked for. The numpy path is asked for explicitly
(``PatchSampler(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "patchops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpatchops-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build failed: g++ not found ({e})") from e
    if res.returncode != 0:
        raise RuntimeError(f"native build failed (g++ exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            cdll.crop_flip_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),  # signals
                ctypes.POINTER(ctypes.c_void_p),  # targets
                ctypes.POINTER(ctypes.c_int64),   # shapes
                ctypes.POINTER(ctypes.c_int64),   # starts
                ctypes.POINTER(ctypes.c_uint8),   # flips
                ctypes.c_void_p,                  # out_signal
                ctypes.c_void_p,                  # out_target
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
            ]
            cdll.crop_flip_batch.restype = None
            cdll.lzw_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            cdll.lzw_decode.restype = ctypes.c_int64
            _lib = cdll
        return _lib


def crop_flip_batch(volumes, starts, flips, patch_size, nthreads: int = 0):
    """Assemble (signal, target) patch batches natively.

    volumes: list of (signal, target or None), each (D, H, W) float32
    C-contiguous; starts: (n, 3) int64; flips: (n, 3) uint8; patch_size:
    (pd, ph, pw). Returns (signal_batch, target_batch), float32 (n, pd, ph,
    pw); a target batch entry whose volume is None is left unwritten.
    """
    n = len(volumes)
    pd, ph, pw = (int(p) for p in patch_size)
    starts = np.ascontiguousarray(starts, np.int64)
    flips = np.ascontiguousarray(flips, np.uint8)
    if starts.shape != (n, 3) or flips.shape != (n, 3):
        raise ValueError(f"starts {starts.shape} / flips {flips.shape}: expected ({n}, 3)")
    sig_ptrs = (ctypes.c_void_p * n)()
    tgt_ptrs = (ctypes.c_void_p * n)()
    shapes = np.empty((n, 3), np.int64)
    for i, (s, t) in enumerate(volumes):
        for v in (s,) if t is None else (s, t):
            if v.dtype != np.float32 or not v.flags.c_contiguous or v.ndim != 3:
                raise ValueError("volumes must be C-contiguous 3-D float32 arrays")
        if t is not None and t.shape != s.shape:
            raise ValueError(f"signal {s.shape} and target {t.shape} differ")
        if any(st < 0 or st + p > d for st, p, d in zip(starts[i], (pd, ph, pw), s.shape)):
            raise ValueError(f"crop {starts[i]} + {patch_size} outside volume {s.shape}")
        sig_ptrs[i] = s.ctypes.data
        tgt_ptrs[i] = t.ctypes.data if t is not None else None
        shapes[i] = s.shape
    out_s = np.empty((n, pd, ph, pw), np.float32)
    out_t = np.empty((n, pd, ph, pw), np.float32)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    lib().crop_flip_batch(
        sig_ptrs, tgt_ptrs,
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_s.ctypes.data, out_t.ctypes.data,
        n, pd, ph, pw, nthreads,
    )
    return out_s, out_t


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    """Decode TIFF-variant LZW into at most ``expected_size`` bytes.
    Raises ValueError on a malformed stream or one that decodes longer."""
    out = np.empty(expected_size, np.uint8)
    n = lib().lzw_decode(data, len(data), out.ctypes.data, expected_size)
    if n < 0:
        raise ValueError("malformed LZW stream")
    return out[:n].tobytes()
