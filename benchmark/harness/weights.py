"""Random weights of a configuration, made on the device from the seed in
the types they are served in, by its architecture module
(``architectures/<architecture>.py``: ``make_state``).

The state is keyed as the port's checkpoints are and is handed to the port
through its public ``load_state_dict``, and to the reference."""

from __future__ import annotations

from typing import Dict

import torch

from .common import architecture


def make_state(cfg: dict, seed: int, device, matrix_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` (a configuration file's dict) for ``seed``,
    matrices in ``matrix_dtype``."""
    return architecture(cfg).make_state(cfg, seed, device, matrix_dtype)
