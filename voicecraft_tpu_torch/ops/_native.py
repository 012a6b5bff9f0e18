"""Build and bind the port's hand-written CUDA kernels.

The sources in ``voicecraft_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
ctypes.  The build happens at first use, into
``build/kernels/<hash of sources and flags>/`` at the root of the checkout
(listed in ``.gitignore``), so a fresh checkout builds everything itself and
an unchanged one reuses its library.  Nothing here runs at import time.

Each wrapper that launches a kernel adds one to its entry of ``LAUNCHES``
right after the launch succeeds, and nowhere else, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh vc::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

LAUNCHES = {"flash_prefix_attention": 0, "fused_ffn": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from csrc/ at "
                           "first use")
    return found


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu unless a library for these exact sources exists.
    Returns (library path, the compiler's stderr: ptxas resource lines, or ""
    when the library was already built)."""
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libvc_kernels.so"
    if lib_path.exists():
        return lib_path, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libvc_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sources if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, proc.stderr


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    if _lib is None:
        path, _ = build()
        L = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.vc_flash_prefix_attention.argtypes = (
            [vp] * 6 + [ci] * 5 + [ctypes.c_float, ci, vp])
        L.vc_flash_prefix_attention.restype = ci
        L.vc_fused_ffn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
        L.vc_fused_ffn.restype = ci
        L.vc_error_string.argtypes = [ci]
        L.vc_error_string.restype = ctypes.c_char_p
        _lib = L
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().vc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the current CUDA device and contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: takes CPU tensors (plain version) or CUDA "
                         f"tensors (kernel), got a tensor on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} but the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte aligned tensors")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
