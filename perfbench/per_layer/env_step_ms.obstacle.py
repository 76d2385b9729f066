"""env_step_ms.obstacle: mean length of the benchmark's span around
``EnvManager.step`` in the traced run's timing slice, on the host
clock with no profiler running (ms): the physics step,
``sim/env_manager.EnvManager.step`` -> ``sim/dynamics.py``,
``control/controllers.py``, ``ops/motor_model.py``, ``envs/collision.py``."""


def read(ctx):
    return ctx["spans"].span_ms("env_step")
