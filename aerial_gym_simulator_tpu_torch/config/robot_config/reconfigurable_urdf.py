"""URDF text of the reconfigurable robots (snakey, snakey5, snakey6, morphy).

Copied from the JAX package's ``config/robot_config/reconfigurable_urdf.py``.
The geometry and inertia numbers are those of the source project's shipped
URDFs; the XML is generated here so nothing outside the package is read.

Structure:
  snakey-N: base_link =fixed= link0 (0.30 kg) =fixed= motor0 (0.00625 kg);
    then per segment k: revolute-z at +0.5 m (limit +/-2.35619449019) ->
    virtual1 -> revolute-x (limit +/-0.5, a twist joint) -> virtual2
    =fixed at +0.5 m= link_k =fixed= motor_k.
  morphy: base_link (0.225 kg, collision sphere r=0.18384776310850237);
    4 arms: revolute-y at the arm root (rpy (0, pi/2, yaw_i), limit
    +/-0.25) -> massless connecting link -> revolute-x (limit +/-0.1) ->
    massless arm link =fixed (0,0,0.07), rpy (0,-pi/2,0)= motor (0.01625 kg).
"""

_LINK_INERTIA = ("0.00042249999999999997", "0.00042249999999999997",
                 "0.0008449999999999999")


def _link(name, mass, ixx="0.0", iyy="0.0", izz="0.0", com="0 0 0",
          geom=""):
    return f"""  <link name="{name}">{geom}
    <inertial>
      <origin xyz="{com}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      <inertia ixx="{ixx}" ixy="0.0" ixz="0.0" iyy="{iyy}" iyz="0.0" izz="{izz}"/>
    </inertial>
  </link>
"""


def _bare_link(name):
    return f'  <link name="{name}"/>\n'


def _joint(name, jtype, parent, child, xyz="0 0 0", rpy="0 0 0", axis=None,
           limit=None):
    s = (f'  <joint name="{name}" type="{jtype}">\n'
         f'    <parent link="{parent}"/>\n    <child link="{child}"/>\n'
         f'    <origin xyz="{xyz}" rpy="{rpy}"/>\n')
    if axis is not None:
        s += f'    <axis xyz="{axis}"/>\n'
    if limit is not None:
        lo, hi, eff, vel = limit
        s += (f'    <limit lower="{lo}" upper="{hi}" effort="{eff}" '
              f'velocity="{vel}"/>\n')
    return s + "  </joint>\n"


def _box_geom(size, xyz="0 0 0"):
    return (f'\n    <collision><origin xyz="{xyz}" rpy="0 0 0"/>'
            f'<geometry><box size="{size}"/></geometry></collision>')


def snakey_urdf(num_motors: int) -> str:
    """snakey (4 motors) / snakey5 / snakey6 model.urdf equivalents."""
    ix, iy, iz = _LINK_INERTIA
    parts = ['<?xml version="1.0"?>\n<robot name="snakey">\n',
             _bare_link("base_link"),
             _link("link0", "0.30", ix, iy, iz,
                   geom=_box_geom("0.9 0.1 0.1")),
             _link("motor0", "0.006249999999999999"),
             _joint("base_link_to_link0", "fixed", "base_link", "link0"),
             _joint("link0_to_motor0", "fixed", "link0", "motor0")]
    for k in range(1, num_motors):
        prev = f"link{k - 1}"
        parts += [
            _bare_link(f"link{k}_virtual1"),
            _bare_link(f"link{k}_virtual2"),
            _link(f"link{k}", "0.30", ix, iy, iz,
                  geom=_box_geom("0.9 0.1 0.1")),
            _link(f"motor{k}", "0.006249999999999999"),
            _joint(f"link{k - 1}_to_link{k}", "revolute", prev,
                   f"link{k}_virtual1", xyz="0.5 0.0 0.0", axis="0 0 1",
                   limit=("-2.35619449019", "2.35619449019", "20.0", "10.0")),
            _joint(f"vl_{k}", "revolute", f"link{k}_virtual1",
                   f"link{k}_virtual2", axis="1 0 0",
                   limit=("-0.5", "0.5", "20.0", "10.0")),
            _joint(f"link{k}_virtual_to_link{k}", "fixed",
                   f"link{k}_virtual2", f"link{k}", xyz="0.5 0.0 0.0"),
            _joint(f"link{k}_to_motor{k}", "fixed", f"link{k}",
                   f"motor{k}"),
        ]
    parts.append("</robot>\n")
    return "".join(parts)


# per-arm root origin and yaw (morphy's base_link_to_connecting_* joints)
_MORPHY_ARMS = [
    ("0.04 -0.032 0.0", "-0.78539816339"),
    ("-0.04 -0.032 0", "-2.35619449019"),
    ("-0.04 0.032 0", "2.3561944901923453"),
    ("0.04 0.032 0", "0.7853981633974482"),
]


def morphy_urdf() -> str:
    ix, iy, iz = _LINK_INERTIA
    sphere = ('\n    <collision><origin xyz="0 0 0"/><geometry>'
              '<sphere radius="0.18384776310850237"/></geometry></collision>')
    parts = ['<?xml version="1.0"?>\n<robot name="morphy">\n',
             _link("base_link", "0.225", ix, iy, iz, geom=sphere)]
    for i, (xyz, yaw) in enumerate(_MORPHY_ARMS):
        parts += [
            _bare_link(f"connecting_link_arm{i}"),
            _link(f"arm_motor_{i}", "0.0"),
            _link(f"motor_{i}", "0.016249999999999999"),
            _joint(f"base_link_to_connecting_link_{i}", "revolute",
                   "base_link", f"connecting_link_arm{i}", xyz=xyz,
                   rpy=f"0.0 1.57079632679 {yaw}", axis="0 1 0",
                   limit=("-0.25", "0.25", "20", "10")),
            _joint(f"connecting_link_to_arm_motor_{i}", "revolute",
                   f"connecting_link_arm{i}", f"arm_motor_{i}", axis="1 0 0",
                   limit=("-0.1", "0.1", "20.0", "10.0")),
            _joint(f"arm_to_motor_{i}", "fixed", f"arm_motor_{i}",
                   f"motor_{i}", xyz="0 0 0.07", rpy="0.0 -1.57079632679 0.0"),
        ]
    parts.append("</robot>\n")
    return "".join(parts)
