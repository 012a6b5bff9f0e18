"""The share of the port's ``decode.step`` spans in the traced request that
replayed the decode step's CUDA graph (a ``decode.replay`` span inside),
%; None where no step replayed one."""
from harness.port_records import slice_spans


def read(res):
    steps = slice_spans(res, "decode.step")
    replays = slice_spans(res, "decode.replay")
    if not steps or not replays:
        return None
    return 100.0 * len(replays) / len(steps)
