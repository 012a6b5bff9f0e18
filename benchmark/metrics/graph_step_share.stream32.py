"""The engine's counters: the steps replayed from the engine step's CUDA
graph over the engine's steps, %, in the window's bursts that ended before
the traced slice began; None where the program's burst records carry no
step counts (a program that counts no replayed steps)."""
from harness.port_records import _engine_records


def read(res):
    rec = _engine_records(res)
    if rec is None:
        return None
    bursts = rec[1]
    steps = sum(getattr(b, "steps", 0) for b in bursts)
    if not steps:
        return None
    return 100.0 * sum(b.graph_steps for b in bursts) / steps
