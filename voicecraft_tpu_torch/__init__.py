"""voicecraft_tpu_torch: the PyTorch and CUDA port of voicecraft-tpu, for
NVIDIA Hopper cards.  It mirrors the layout of ``voicecraft_tpu`` (ops/,
models/, inference/, data/, utils/) and imports no JAX; the JAX package
stays the reference it is tested against."""

import tempfile
from pathlib import Path

__version__ = "0.1.0"

from .config import PRESETS, ModelConfig  # noqa: F401

# where the port builds its native code at first use (ops/_native.py: the
# CUDA kernels, native/: the code-file reader): inside the package, in a
# checkout (.gitignore lists every build/) as in an installed copy
BUILD_DIR = Path(__file__).resolve().parent / "build"


def writable_dir(path: Path, what: str) -> None:
    """Create ``path`` and check that a file can be written there; raise
    naming the path otherwise (a build has no other place to go)."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path):
            pass
    except OSError as e:
        raise RuntimeError(f"cannot build the {what} into {path}: {e}") from e
