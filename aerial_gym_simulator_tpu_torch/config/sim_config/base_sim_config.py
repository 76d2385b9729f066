"""Simulation config (dt, gravity), copied from the JAX package's
``config/sim_config/base_sim_config.py``: ``base_sim``, its headless
twin, the 2 ms and 4 ms steps and the gravity-free sim."""

from dataclasses import dataclass
from typing import Tuple


@dataclass
class SimConfig:
    name: str = "base_sim"
    dt: float = 0.01
    substeps: int = 1
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    integrator: str = "semi_implicit_euler"


@dataclass
class BaseSimConfig(SimConfig):
    name: str = "base_sim"
    dt: float = 0.01


@dataclass
class BaseSimHeadlessConfig(SimConfig):
    name: str = "base_sim_headless"
    dt: float = 0.01


@dataclass
class SimConfig2Ms(SimConfig):
    name: str = "base_sim_2ms"
    dt: float = 0.002


@dataclass
class SimConfig4Ms(SimConfig):
    name: str = "base_sim_4ms"
    dt: float = 0.004


@dataclass
class BaseSimNoGravityConfig(SimConfig):
    name: str = "base_sim_no_gravity"
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
