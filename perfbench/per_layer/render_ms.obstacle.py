"""render_ms.obstacle: mean length of the benchmark's span around
``EnvManager.render`` in the traced run's timing slice, on the host
clock with no profiler running (ms): ``sensors/raycast_sensor.py``
and the ray-cast kernel (depth + segmentation)."""


def read(ctx):
    return ctx["spans"].span_ms("render")
