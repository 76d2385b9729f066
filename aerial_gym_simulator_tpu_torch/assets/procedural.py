"""Procedural robot/obstacle URDF generation.

Copied from the JAX package's ``assets/procedural.py``: multirotor frames
from an arm layout, box/cylinder obstacles from shape parameters, and
trees (trunk, crown, branches).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def _inertia_xml(ixx, iyy, izz):
    return (f'<inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" iyz="0" '
            f'izz="{izz}"/>')


def multirotor_urdf(
    name: str = "quad",
    motor_positions: Sequence[Tuple[float, float, float]] = (
        (0.13, -0.13, 0.0),
        (-0.13, -0.13, 0.0),
        (-0.13, 0.13, 0.0),
        (0.13, 0.13, 0.0),
    ),
    base_mass: float = 0.225,
    motor_mass: float = 0.00625,
    base_ixx: float = 4.225e-4,
    base_iyy: float = 4.225e-4,
    base_izz: float = 8.45e-4,
    base_size: Tuple[float, float, float] = (0.15, 0.15, 0.05),
    rotor_radius: float = 0.08,
) -> str:
    """Generate an n-rotor URDF: a box base link + point-mass motor links.

    Default parameters reproduce the reference quad's mass properties
    (total mass 0.25 kg, motors on 0.13 m X-arms)."""
    links = [f"""
  <link name="base_link">
    <inertial>
      <origin xyz="0 0 0"/>
      <mass value="{base_mass}"/>
      {_inertia_xml(base_ixx, base_iyy, base_izz)}
    </inertial>
    <collision>
      <origin xyz="0 0 0"/>
      <geometry><box size="{base_size[0]} {base_size[1]} {base_size[2]}"/></geometry>
    </collision>
  </link>"""]
    joints = []
    for i, (x, y, z) in enumerate(motor_positions):
        links.append(f"""
  <link name="motor_{i}">
    <inertial>
      <origin xyz="0 0 0"/>
      <mass value="{motor_mass}"/>
      {_inertia_xml(0.0, 0.0, 0.0)}
    </inertial>
    <collision>
      <origin xyz="0 0 0"/>
      <geometry><cylinder radius="{rotor_radius}" length="0.01"/></geometry>
    </collision>
  </link>""")
        joints.append(f"""
  <joint name="base_to_motor_{i}" type="fixed">
    <parent link="base_link"/>
    <child link="motor_{i}"/>
    <origin xyz="{x} {y} {z}" rpy="0 0 0"/>
  </joint>""")
    return f'<robot name="{name}">{"".join(links)}{"".join(joints)}\n</robot>'


def motor_layout_from_allocation(alloc: Sequence[Sequence[float]]):
    """Recover planar motor positions from a standard z-thrust allocation
    matrix: row 3 = -y arms, row 4 = +x arms (torque = r x f, f = z)."""
    alloc = np.asarray(alloc, dtype=np.float64)
    n = alloc.shape[1]
    # With per-motor thrust f_i along +z at offset r_i: tau = r x f, so
    # tau_x = +r_y * f and tau_y = -r_x * f. The allocation rows therefore
    # encode r_y in row 3 and -r_x in row 4.
    ry = alloc[3]
    rx = -alloc[4]
    return [(float(rx[i]), float(ry[i]), 0.0) for i in range(n)]


def box_urdf(name: str, size: Tuple[float, float, float], mass: float = 0.0) -> str:
    m = max(mass, 1e-6)
    sx, sy, sz = size
    ixx = m / 12.0 * (sy * sy + sz * sz)
    iyy = m / 12.0 * (sx * sx + sz * sz)
    izz = m / 12.0 * (sx * sx + sy * sy)
    return f"""<robot name="{name}">
  <link name="{name}_link">
    <inertial><mass value="{m}"/>{_inertia_xml(ixx, iyy, izz)}</inertial>
    <collision><geometry><box size="{sx} {sy} {sz}"/></geometry></collision>
  </link>
</robot>"""


def cylinder_urdf(name: str, radius: float, length: float, mass: float = 0.0) -> str:
    m = max(mass, 1e-6)
    ixx = m / 12.0 * (3 * radius * radius + length * length)
    izz = 0.5 * m * radius * radius
    return f"""<robot name="{name}">
  <link name="{name}_link">
    <inertial><mass value="{m}"/>{_inertia_xml(ixx, ixx, izz)}</inertial>
    <collision><origin xyz="0 0 {length/2}"/><geometry><cylinder radius="{radius}" length="{length}"/></geometry></collision>
  </link>
</robot>"""


def tree_urdf(name: str, trunk_radius: float = 0.08, trunk_height: float = 2.5,
              crown_radius: float = 0.8, seed: int = 0) -> str:
    """A tree: trunk cylinder, crown sphere and three branch boxes whose
    angle, height and length are drawn from ``np.random.RandomState(seed)``;
    the same text as the JAX package's, byte for byte."""
    rng = np.random.RandomState(seed)
    branches = []
    joints = []
    for i in range(3):
        ang = float(rng.uniform(0, 2 * math.pi))
        h = float(rng.uniform(0.4, 0.9)) * trunk_height
        L = float(rng.uniform(0.3, 0.8))
        branches.append(f"""
  <link name="branch_{i}">
    <inertial><mass value="1e-6"/>{_inertia_xml(0, 0, 0)}</inertial>
    <collision><geometry><box size="{L} 0.04 0.04"/></geometry></collision>
  </link>""")
        joints.append(f"""
  <joint name="trunk_to_branch_{i}" type="fixed">
    <parent link="trunk"/><child link="branch_{i}"/>
    <origin xyz="{0.5*L*math.cos(ang)} {0.5*L*math.sin(ang)} {h}" rpy="0 0 {ang}"/>
  </joint>""")
    return f"""<robot name="{name}">
  <link name="trunk">
    <inertial><mass value="1e-6"/>{_inertia_xml(0, 0, 0)}</inertial>
    <collision><origin xyz="0 0 {trunk_height/2}"/><geometry><cylinder radius="{trunk_radius}" length="{trunk_height}"/></geometry></collision>
  </link>
  <link name="crown">
    <inertial><mass value="1e-6"/>{_inertia_xml(0, 0, 0)}</inertial>
    <collision><geometry><sphere radius="{crown_radius}"/></geometry></collision>
  </link>
  <joint name="trunk_to_crown" type="fixed">
    <parent link="trunk"/><child link="crown"/>
    <origin xyz="0 0 {trunk_height}"/>
  </joint>{"".join(branches)}{"".join(joints)}
</robot>"""
