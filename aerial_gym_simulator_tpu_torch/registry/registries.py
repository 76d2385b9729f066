"""Name registries for sim/env/robot/controller composition, copied from
the JAX package's ``registry/registries.py``.

Configs are registered as zero-arg factories so every build gets a fresh,
independently overridable config object.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


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
