"""URDF joint tree -> the articulation the coupled solver steps.

Copied from the JAX package's ``assets/articulation.py``: moving bodies
(one per revolute joint, fixed subtrees merged by the parallel-axis
theorem), the kinematic tree, and each motor's attachment (owning body,
position, thrust direction). Thrust acts on the motor links, so the moment
arms move with the joints; ``sim/articulated.py`` consumes the result.

Load-time only; runs once per robot type at build.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .urdf import _parse_origin

# links named motor<k> or motor_<k> carry thrust along their local +z
_MOTOR_RE = re.compile(r"^motor_?(\d+)$")


@dataclass
class ArticulationModel:
    """Floating base + revolute-joint tree, fixed joints collapsed.

    Moving body i is the child subtree of revolute joint i; indices follow
    the URDF's joint declaration order, which is the DOF order
    ReconfigurationConfig lists its gains in.
    """
    nb: int                                   # number of moving bodies (= DOFs)
    parent: List[int]                         # per body; -1 = base
    joint_names: List[str]
    R_tree: np.ndarray                        # (nb,3,3) child->parent coords @ q=0
    t_tree: np.ndarray                        # (nb,3) joint origin in parent frame
    axis: np.ndarray                          # (nb,3) in child frame
    lower: np.ndarray                         # (nb,) joint limits from URDF
    upper: np.ndarray
    effort: np.ndarray                        # (nb,) drive effort clamp
    velocity: np.ndarray                      # (nb,) joint velocity clamp
    mass: np.ndarray                          # (nb,)
    com: np.ndarray                           # (nb,3) in body frame
    inertia: np.ndarray                       # (nb,3,3) about com, body frame
    base_mass: float = 0.0
    base_com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    base_inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # motors sorted by index parsed from the link name
    motor_body: List[int] = field(default_factory=list)   # -1 = base
    motor_pos: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    motor_dir: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))

    @property
    def total_mass(self) -> float:
        return float(self.base_mass + self.mass.sum())


def _link_inertial(link) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """(mass, com_in_link_frame, inertia_about_com_link_axes) or None."""
    inertial = link.find("inertial")
    if inertial is None:
        return None
    m = float(inertial.find("mass").get("value"))
    i_xyz, i_R = _parse_origin(inertial)
    I = np.zeros((3, 3))
    ie = inertial.find("inertia")
    if ie is not None:
        ixx = float(ie.get("ixx", 0)); iyy = float(ie.get("iyy", 0))
        izz = float(ie.get("izz", 0)); ixy = float(ie.get("ixy", 0))
        ixz = float(ie.get("ixz", 0)); iyz = float(ie.get("iyz", 0))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return m, i_xyz, i_R @ I @ i_R.T


def parse_articulation(text: str) -> Optional[ArticulationModel]:
    """URDF string -> ArticulationModel; None when there is no revolute joint."""
    root = ET.fromstring(text)

    links = {l.get("name"): l for l in root.findall("link")}
    joints = []
    children = set()
    for j in root.findall("joint"):
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        xyz, R = _parse_origin(j)
        ax_el = j.find("axis")
        axis = (np.array([float(v) for v in ax_el.get("xyz").split()])
                if ax_el is not None else np.array([1.0, 0.0, 0.0]))
        lim = j.find("limit")
        limits = (
            float(lim.get("lower", -np.pi)) if lim is not None else -np.pi,
            float(lim.get("upper", np.pi)) if lim is not None else np.pi,
            float(lim.get("effort", 1e9)) if lim is not None else 1e9,
            float(lim.get("velocity", 1e9)) if lim is not None else 1e9,
        )
        joints.append(dict(name=j.get("name"), type=j.get("type"),
                           parent=parent, child=child, xyz=xyz, R=R,
                           axis=axis, limits=limits))
        children.add(child)
        if j.get("type") not in ("revolute", "continuous", "fixed"):
            raise NotImplementedError(
                f"joint type {j.get('type')} not supported (the robots use "
                f"revolute and fixed joints only)")

    if not any(j["type"] in ("revolute", "continuous") for j in joints):
        return None

    roots = [n for n in links if n not in children]
    base = roots[0] if roots else next(iter(links))

    # --- assign every link to a moving body (or the base), with its pose in
    # that body's frame; moving bodies are created in URDF joint order
    # link -> (body_idx, t, R): pose of link frame in owning body frame
    own: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {
        base: (-1, np.zeros(3), np.eye(3))}
    bodies: List[dict] = []   # per moving body: parent, R_tree, t_tree, axis, limits
    by_parent: Dict[str, List[dict]] = {}
    for j in joints:
        by_parent.setdefault(j["parent"], []).append(j)

    # traverse in URDF joint order but only when the parent is resolved
    pending = list(joints)
    guard = 0
    while pending and guard <= len(joints):
        guard += 1
        rest = []
        for j in pending:
            if j["parent"] not in own:
                rest.append(j)
                continue
            b_idx, t_p, R_p = own[j["parent"]]
            if j["type"] == "fixed":
                own[j["child"]] = (b_idx, t_p + R_p @ j["xyz"], R_p @ j["R"])
            else:
                new_idx = len(bodies)
                bodies.append(dict(
                    parent=b_idx,
                    name=j["name"],
                    # joint frame in the PARENT BODY frame (accumulate the
                    # owning chain of fixed transforms)
                    t_tree=t_p + R_p @ j["xyz"],
                    R_tree=R_p @ j["R"],
                    axis=j["axis"],
                    limits=j["limits"],
                ))
                own[j["child"]] = (new_idx, np.zeros(3), np.eye(3))
        pending = rest
    if pending:
        raise ValueError(f"unreachable links via joints: "
                         f"{[j['child'] for j in pending]}")

    nb = len(bodies)

    # --- aggregate inertials per body
    agg = [dict(m=0.0, mc=np.zeros(3), contribs=[]) for _ in range(nb + 1)]
    for name, link in links.items():
        if name not in own:
            raise ValueError(f"link {name} not connected to the tree")
        b_idx, t_l, R_l = own[name]
        inert = _link_inertial(link)
        if inert is None:
            continue
        m, com_l, I_l = inert
        com_b = t_l + R_l @ com_l
        I_b = R_l @ I_l @ R_l.T
        a = agg[b_idx + 1]
        a["m"] += m
        a["mc"] += m * com_b
        a["contribs"].append((m, com_b, I_b))

    def _finish(a):
        m = a["m"]
        com = a["mc"] / m if m > 0 else np.zeros(3)
        I = np.zeros((3, 3))
        for mi, ci, Ii in a["contribs"]:
            d = ci - com
            I += Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        return m, com, I

    base_mass, base_com, base_I = _finish(agg[0])
    masses, coms, inertias = [], [], []
    for i in range(nb):
        m, c, I = _finish(agg[i + 1])
        masses.append(m); coms.append(c); inertias.append(I)

    # --- motors: thrust along the motor link's local +z
    motors = []
    for name in links:
        m = _MOTOR_RE.match(name)
        if m is None:
            continue
        b_idx, t_l, R_l = own[name]
        motors.append((int(m.group(1)), b_idx, t_l, R_l[:, 2]))
    motors.sort(key=lambda x: x[0])

    return ArticulationModel(
        nb=nb,
        parent=[b["parent"] for b in bodies],
        joint_names=[b["name"] for b in bodies],
        R_tree=np.stack([b["R_tree"] for b in bodies]),
        t_tree=np.stack([b["t_tree"] for b in bodies]),
        axis=np.stack([b["axis"] for b in bodies]),
        lower=np.array([b["limits"][0] for b in bodies]),
        upper=np.array([b["limits"][1] for b in bodies]),
        effort=np.array([b["limits"][2] for b in bodies]),
        velocity=np.array([b["limits"][3] for b in bodies]),
        mass=np.array(masses),
        com=np.stack(coms),
        inertia=np.stack(inertias),
        base_mass=base_mass,
        base_com=base_com,
        base_inertia=base_I,
        motor_body=[mb for _, mb, _, _ in motors],
        motor_pos=(np.stack([p for _, _, p, _ in motors])
                   if motors else np.zeros((0, 3))),
        motor_dir=(np.stack([d for _, _, _, d in motors])
                   if motors else np.zeros((0, 3))),
    )
