"""update.idle_ms.ppo: the device's idle time while the host was inside the
port's ``ppo.update`` span, over the number of ``ppo.update`` spans in rank
0's traced slice (ms; ``harness/program_spans.py``). Read under the
profiler, which lengthens each launch on the host."""

from perfbench.harness.program_spans import totals


def read(ctx):
    t = totals(ctx, "ppo.update")
    return None if t is None else t["idle_us"] / t["calls"] * 1e-3
