"""Build and bind the port's hand-written CUDA kernels.

The sources in ``voicecraft_tpu_torch/csrc`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
ctypes.  The build happens at first use, into
``voicecraft_tpu_torch/build/kernels/<hash of sources and flags>/``, inside
the package itself, whether it runs from a checkout (where ``.gitignore``
lists every ``build/``) or from an installed copy: a fresh copy builds
everything itself, an unchanged one reuses its library, and nothing is
written beside the package.  A build directory that cannot be written
raises with its path.  Nothing here runs at import time.

Each wrapper that launches a kernel adds one to its entry of ``LAUNCHES``
(and, for a kernel with several routes, of ``ROUTE_LAUNCHES``) right after
the launch succeeds, and nowhere else, so a run can show which kernels its
main path went through.  A launch inside a CUDA graph's capture runs at
each replay: :class:`GraphLaunches` moves its count there.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import BUILD_DIR, writable_dir

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = BUILD_DIR / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh vc::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float8_e4m3fn: "fp8"}

LAUNCHES = {"flash_prefix_attention": 0, "fused_ffn": 0,
            "ring_decode_attention": 0, "kda_recurrent": 0}
# the same launches by route, "<kernel>/<weight dtype>" ("sm90/fp8", ...)
ROUTE_LAUNCHES = collections.Counter()

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def count_launch(name: str, route: Optional[str] = None) -> None:
    """One launch of kernel ``name`` (and of ``route``, when the kernel has
    several), counted right after it succeeded."""
    LAUNCHES[name] += 1
    if route is not None:
        ROUTE_LAUNCHES[f"{name}:{route}"] += 1


def launch_counts() -> collections.Counter:
    """Every count of ``LAUNCHES`` and ``ROUTE_LAUNCHES`` in one Counter
    (a route's key, "<kernel>:<route>", is never a kernel's)."""
    counts = collections.Counter(LAUNCHES)
    counts.update(ROUTE_LAUNCHES)
    return counts


def add_launch_counts(counts: collections.Counter, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (as :func:`launch_counts` gives them) to
    the counts."""
    for key, n in counts.items():
        if key in LAUNCHES:
            LAUNCHES[key] += times * n
        else:
            ROUTE_LAUNCHES[key] += times * n


class GraphLaunches:
    """The launches of one CUDA graph.  ``with GraphLaunches() as g:``
    around the capture takes what the capture counted back out of the
    counts, since a capture runs nothing, and keeps it in ``g.per_replay``;
    ``g.replayed()`` after each replay adds it again.  A decode that
    replays a captured step then leaves the counts an eager one leaves."""

    def __enter__(self):
        self._before = launch_counts()
        return self

    def __exit__(self, *exc):
        self.per_replay = launch_counts() - self._before
        add_launch_counts(self.per_replay, -1)
        return False

    def replayed(self) -> None:
        add_launch_counts(self.per_replay)


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
    """Compile csrc/*.cu unless a library for these exact sources exists:
    one nvcc per source, all started together, then one link.  Returns
    (library path, the compiler's stderr: ptxas resource lines, or "" when
    the library was already built)."""
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libvc_kernels.so"
    if lib_path.exists():
        return lib_path, ""
    writable_dir(out_dir, "kernel library")
    tag = f"{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in (p for p in sources if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = [proc.communicate()[1] for _, _, proc in jobs]   # wait for all
    for (cmd, _, proc), err in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:"
                               f"\n{' '.join(cmd)}\n{err}")
    tmp = out_dir / f"libvc_kernels.{tag}.so"
    cmd = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
           *[str(obj) for _, obj, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return lib_path, "".join(logs) + proc.stderr


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
        L.vc_fused_ffn.argtypes = [vp] * 10 + [ci] * 6 + [vp, vp]
        L.vc_fused_ffn.restype = ci
        ll = ctypes.c_longlong
        L.vc_ring_decode_attention.argtypes = (
            [vp] * 5 + [ll] * 3 + [vp] * 5 + [ci] * 7
            + [ctypes.c_float, ci, vp])
        L.vc_ring_decode_attention.restype = ci
        L.vc_kda_recurrent.argtypes = (
            [vp] * 8 + [ci] * 5 + [ctypes.c_float, ci, vp])
        L.vc_kda_recurrent.restype = ci
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
