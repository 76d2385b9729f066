"""aerial_gym_simulator_tpu_torch — the aerial gym simulator on PyTorch and
CUDA (NVIDIA Hopper).

A port of the JAX package ``aerial_gym_simulator_tpu``, which stays the
reference it is tested against. This package imports torch, numpy and the
standard library only. Importing it registers the named sim, env, robot
and controller configs and the tasks it carries.
"""

__version__ = "0.1.0"

from .registry.registries import (  # noqa: F401
    controller_registry,
    env_config_registry,
    robot_registry,
    sim_config_registry,
    task_registry,
)
from .config import register_all as _register_configs

_register_configs()

from .sim.sim_builder import SimBuilder  # noqa: F401, E402
from .tasks import register_all as _register_tasks  # noqa: E402

_register_tasks()
