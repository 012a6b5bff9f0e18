"""voicecraft_tpu_torch: the PyTorch and CUDA port of voicecraft-tpu, for
NVIDIA Hopper cards.  It mirrors the layout of ``voicecraft_tpu`` (ops/,
models/, inference/, data/, utils/) and imports no JAX; the JAX package
stays the reference it is tested against."""

__version__ = "0.1.0"

from voicecraft_tpu.config import PRESETS, ModelConfig  # noqa: F401
