"""Simulation config (dt, gravity), copied from the JAX package's
``config/sim_config/base_sim_config.py`` and cut to ``base_sim``."""

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
