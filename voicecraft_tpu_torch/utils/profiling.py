"""Meters and device traces for training (PyTorch port of
voicecraft_tpu/utils/profiling.py): the reference's wall-clock
AverageMeters (steps/trainer.py:162-166), and torch.profiler traces (CPU
and CUDA activity, a Chrome trace per window) in place of jax.profiler's.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger("voicecraft_tpu_torch.profiling")


class AverageMeter:
    """Running average (reference trainer_utils.py:142-157 semantics)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(log_dir: str) -> torch.profiler.profile:
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def _stop(prof: torch.profiler.profile, log_dir: str) -> str:
    prof.stop()
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed region into a Chrome trace under ``log_dir``."""
    prof = _start(log_dir)
    t0 = time.time()
    try:
        yield prof
    finally:
        path = _stop(prof, log_dir)
        log.info("profiler trace (%.2fs) written to %s", time.time() - t0, path)


class StepProfiler:
    """Traces steps [start, stop) of a training run into ``log_dir``."""

    def __init__(self, log_dir: Optional[str], start: int = 10, stop: int = 13):
        self.log_dir = log_dir
        self.start, self.stop = start, stop
        self._prof: Optional[torch.profiler.profile] = None

    def step(self, step_idx: int):
        if self.log_dir is None:
            return
        if step_idx == self.start and self._prof is None:
            self._prof = _start(self.log_dir)
            log.info("profiler: tracing steps %d..%d", self.start, self.stop)
        elif step_idx >= self.stop and self._prof is not None:
            self.close()

    def close(self):
        if self._prof is not None:
            path = _stop(self._prof, self.log_dir)
            self._prof = None
            log.info("profiler: trace written to %s", path)
