"""ctypes bridge to the native code-file reader (dataio.cpp; a copy of the
JAX package's voicecraft_tpu/native).

The shared library is built with g++ at first use into
``build/native/<hash of the source>/`` at the root of the checkout (listed in
``.gitignore``), never next to the source.  The pure-Python reader
(``py_load_codes``) reads the same files into the same arrays; it serves
when no g++ is on the machine, with a warning.  This is host I/O, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("voicecraft_tpu_torch.native")

_SRC = Path(__file__).resolve().parent / "dataio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libvcdataio.so"


def build() -> Path:
    """Compile dataio.cpp unless this source's library exists; the library
    is written to a temporary name and renamed, so concurrent builders
    never load a half-written file."""
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp, "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built at first call; None (after one warning)
    where it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native dataio unavailable (%s); reading code files "
                    "in Python", e)
        return None
    lib.vc_load_codes.restype = ctypes.c_int
    lib.vc_load_codes.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.vc_load_codes_batch.restype = ctypes.c_int
    lib.vc_load_codes_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    _lib = lib
    return _lib


def py_load_codes(path: str, n_codebooks: int) -> Optional[np.ndarray]:
    """The pure-Python reader: K rows of ints -> [K, T] int32 (T the
    shortest row), or None where the file is short or malformed."""
    try:
        with open(path) as f:
            rows = [ln.split() for i, ln in enumerate(f) if i < n_codebooks]
        if len(rows) < n_codebooks or any(not r for r in rows):
            return None
        t = min(len(r) for r in rows)
        return np.asarray([[int(v) for v in r[:t]] for r in rows], np.int32)
    except (OSError, ValueError):
        return None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_codes(path: str, n_codebooks: int,
               max_t: int = 8192) -> Optional[np.ndarray]:
    """Read one K-row code file -> [K, T] int32, or None."""
    lib = get_lib()
    if lib is None:
        return py_load_codes(path, n_codebooks)
    buf = np.empty((n_codebooks, max_t), np.int32)
    t = lib.vc_load_codes(path.encode(), n_codebooks, _i32p(buf), max_t)
    return None if t < 0 else buf[:, :t].copy()


def load_codes_batch(paths: List[str], n_codebooks: int, max_t: int = 8192,
                     n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Read code files in parallel -> a [K, T_i] array (or None) each."""
    lib = get_lib()
    if lib is None:
        return [py_load_codes(p, n_codebooks) for p in paths]
    n = len(paths)
    buf = np.empty((n, n_codebooks, max_t), np.int32)
    lens = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.vc_load_codes_batch(arr, n, n_codebooks, _i32p(buf), max_t,
                            _i32p(lens), n_threads)
    return [buf[i, :, :lens[i]].copy() if lens[i] >= 0 else None
            for i in range(n)]
