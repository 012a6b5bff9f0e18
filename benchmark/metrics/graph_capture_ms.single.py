"""Mean wall of the port's ``decode.capture`` spans in the traced request:
the host capturing the decode step in a CUDA graph and instantiating it,
ms; None where no step was captured."""
from harness.port_records import slice_spans


def read(res):
    walls = [e - s for s, e in slice_spans(res, "decode.capture")]
    return sum(walls) / len(walls) / 1e3 if walls else None
