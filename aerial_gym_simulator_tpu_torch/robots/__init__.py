"""Robot layer: the public re-export surface.

Counterpart of ``aerial_gym_simulator_tpu/robots/__init__.py``, with the
same names. Robot behaviour lives in the functional core:

  * the per-step dynamics pipeline (controller -> allocation -> motor lag
    -> drag -> disturbance -> integration): ``sim/dynamics.py``
  * the coupled articulation of the reconfigurable robots (snakey, morphy):
    ``sim/articulated.py``
  * the robot catalog, one constructor per reference robot config:
    ``config/robot_config/catalog.py``
  * URDF -> articulation extraction: ``assets/articulation.py``

so that ``from aerial_gym_simulator_tpu_torch import robots`` reads like
the reference's robot layer.
"""

from ..assets.articulation import ArticulationModel, parse_articulation
from ..config.robot_config.catalog import (
    base_octarotor,
    base_quadrotor,
    base_random,
    base_rov,
    lmf1,
    lmf2,
    lmf2_radar,
    magpie,
    morphy,
    morphy_fixed_base,
    morphy_stiff,
    register_robots,
    snakey,
    snakey5,
    snakey6,
    tinyprop,
    x500,
)
from ..config.robot_config.reconfigurable_urdf import morphy_urdf, snakey_urdf

__all__ = [
    "ArticulationModel",
    "parse_articulation",
    "register_robots",
    "base_quadrotor",
    "base_octarotor",
    "base_rov",
    "base_random",
    "lmf1",
    "lmf2",
    "lmf2_radar",
    "x500",
    "tinyprop",
    "magpie",
    "snakey",
    "snakey5",
    "snakey6",
    "morphy",
    "morphy_stiff",
    "morphy_fixed_base",
    "morphy_urdf",
    "snakey_urdf",
]
