"""The benchmark harness of voicecraft_tpu_torch: one cell, one run.

Everything here reads what a cell is from data (BENCHMARK.json, the
configuration's file, the traffic's file) and finds the code that serves
it by name (``drivers/<driver>.py``, ``metrics/<metric>.py``).  Nothing
here imports JAX or the JAX package, and nothing of the port is imported
when a module of the harness is imported.
"""
