"""task_step_ms.nav: mean length of the benchmark's span around the
navigation task's ``task.step`` in the traced run's timing slice, on the host
clock with no profiler running (ms): physics, the
depth render, the ViT encoder, reward and curriculum."""


def read(ctx):
    return ctx["spans"].span_ms("task_step")
