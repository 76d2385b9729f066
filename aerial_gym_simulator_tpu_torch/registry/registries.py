"""Name registries for sim/env/robot/controller/task composition, copied
from the JAX package's ``registry/registries.py``.

Configs are registered as zero-arg factories so every build gets a fresh,
independently overridable config object.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


class ConfigRegistry:
    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[[], Any]] = {}

    def register(self, name: str, factory: Callable[[], Any]):
        self._factories[name] = factory

    def make(self, name: str):
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} '{name}'; registered: {sorted(self._factories)}")
        cfg = self._factories[name]()
        if hasattr(cfg, "name"):
            cfg.name = name
        return cfg

    def get_names(self):
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        return name in self._factories


sim_config_registry = ConfigRegistry("sim config")
env_config_registry = ConfigRegistry("env config")
robot_registry = ConfigRegistry("robot")
controller_registry = ConfigRegistry("controller")


class TaskRegistry:
    """name -> (task_class, task_config_factory)."""

    def __init__(self):
        self._tasks: Dict[str, Tuple[type, Callable[[], Any]]] = {}

    def register_task(self, name: str, task_class: type,
                      config_factory: Callable[[], Any]):
        self._tasks[name] = (task_class, config_factory)

    def get_task_names(self):
        return sorted(self._tasks)

    def get_task_config(self, name: str):
        return self._tasks[name][1]()

    def make_task(self, task_name: str, seed=None, num_envs=None, headless=None,
                  use_warp=None, task_config=None, **kwargs):
        """task_config overrides the registered config instance (pass a
        modified copy from get_task_config() for one-off customization);
        ``device="cpu"`` in kwargs runs the task on the CPU, and ``shard=``
        (a ``parallel.mesh.EnvShard`` of ``num_envs`` global envs) builds
        this rank's block of the env axis alone."""
        if task_name not in self._tasks:
            raise KeyError(
                f"unknown task '{task_name}' (ROADMAP.md §A lists the tasks not "
                f"ported yet); registered: {sorted(self._tasks)}")
        task_class, config_factory = self._tasks[task_name]
        config = task_config if task_config is not None else config_factory()
        return task_class(config, seed=seed, num_envs=num_envs,
                          headless=headless, use_warp=use_warp, **kwargs)


task_registry = TaskRegistry()
