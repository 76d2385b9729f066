"""physics.idle_ms: the device's idle time while the host was inside the
port's ``physics`` span (children included), over the number of
``physics`` spans in the traced slice (ms; ``harness/program_spans.py``)."""

from perfbench.harness.program_spans import totals


def read(ctx):
    t = totals(ctx, "physics")
    return None if t is None else t["idle_us"] / t["calls"] * 1e-3
