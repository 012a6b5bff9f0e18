"""Decode steps replayed from CUDA graphs: the one capture policy
(:class:`StepReplay`) of the decode loop, the engine and DeepSeek-V2's
per-part steps, each caller wrapping its own spans around its calls."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from . import _native


def step_graph_engages(model) -> bool:
    """Whether a model's decode steps are replayed from CUDA graphs: its
    tensors are on a CUDA device and its decoder is not split over a
    mesh's 'model' axis (a split step runs collectives, which are not
    captured).  Either block: DeepSeek-V2's expert layers route with no
    host sync and no shape taken from the routing (ops/moe.py)."""
    mesh = getattr(model.decoder, "mesh", None)
    return (model.device.type == "cuda"
            and not (mesh is not None and mesh.n_model > 1))


_sites = threading.local()


class CaptureSite:
    """This thread's place on one device to capture steps: a stream other
    than the default one, which a capture needs (a step's eager first call
    there settles what the capture reuses: cuBLAS's workspace for that
    stream, kernel attributes, cached constants), and its last graph, kept
    so that the next capture shares its memory pool: a pool of its own
    stays reserved until a cudaMalloc fails (a 2 MiB segment a decode)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.stream = torch.cuda.Stream(idx)
        self.last: Optional[torch.cuda.CUDAGraph] = None

    @staticmethod
    def of(device: torch.device) -> "CaptureSite":
        sites = getattr(_sites, "by_device", None)
        if sites is None:
            sites = _sites.by_device = {}
        idx = (torch.cuda.current_device() if device.index is None
               else device.index)
        if idx not in sites:
            sites[idx] = CaptureSite(idx)
        return sites[idx]

    @contextlib.contextmanager
    def running(self):
        """Run the block on the site's stream, ordered after the work
        queued on the current stream and before the work queued there
        after it."""
        main = torch.cuda.current_stream(self.idx)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


class StepGraph:
    """``fn`` captured (not run) in a CUDA graph on the capture site, in
    the pool of its last capture; ``out`` is what ``fn`` returned, tensors
    each replay fills.  A replay runs the captured kernels on the tensors
    the capture saw and draws from ``generators`` (registered with the
    graph) where ``fn`` draws, advancing their Philox offsets as an eager
    call does.  The fused FFN's launch counts move from the capture to the
    replays (ops/_native.py:GraphLaunches)."""

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator],
                 device: torch.device):
        site = CaptureSite.of(device)
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        pool = None if site.last is None else site.last.pool()
        with site.running(), _native.GraphLaunches() as self.launches:
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        site.last = self.graph

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()


class StepReplay:
    """One step's capture policy, called once a step with a function that
    runs the step on the same tensors.  Where ``engaged``, call 0 runs it
    eagerly on the capture site's stream, call 1 captures and replays it,
    later calls replay it; elsewhere every call runs it eagerly.  A call
    returns the step's output (``StepGraph.out`` if replayed, which it was
    iff ``graph`` is set after it); ``capture`` is public for a span."""

    def __init__(self, device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 engaged: bool = True):
        self.device, self.generators = device, tuple(generators)
        self.engaged = engaged
        self.calls = 0
        self.graph: Optional[StepGraph] = None

    @property
    def capture_due(self) -> bool:
        return self.engaged and self.graph is None and self.calls >= 1

    def capture(self, fn: Callable) -> None:
        self.graph = StepGraph(fn, self.generators, self.device)

    def __call__(self, fn: Callable):
        if self.capture_due:
            self.capture(fn)
        self.calls += 1
        if self.graph is not None:
            self.graph.replay()
            return self.graph.out
        if not self.engaged:
            return fn()
        with CaptureSite.of(self.device).running():
            return fn()
