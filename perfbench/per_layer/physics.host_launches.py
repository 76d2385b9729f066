"""physics.host_launches: the runtime or driver calls that enqueued device
work while the host was inside the port's ``physics`` span
(``sim/dynamics.env_step``, its substeps' control, integration and contact
included), over the number of ``physics`` spans in the traced slice. A
graph launch counts once (``harness/program_spans.py``)."""

from perfbench.harness.program_spans import totals


def read(ctx):
    t = totals(ctx, "physics")
    return None if t is None else t["launches"] / t["calls"]
