"""Host-side URDF parsing: mass/inertia aggregation + primitive extraction.

Copied from the JAX package's ``assets/urdf.py``: box, cylinder and sphere
geometry become primitives, and ``<mesh>`` geometry becomes one triangle
primitive per face (``assets/mesh.py``), or a box of 0.1 x scale when the
mesh file cannot be resolved. Primitive-only URDFs go through the native
compiler (``assets/native_loader.py``) where the JAX package sends them
there; ``AERIAL_GYM_TPU_NATIVE_LOADER=0`` chooses this module's parser.
Load-time only; runs once per robot/asset variant.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def _rpy_to_matrix(rpy):
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    # intrinsic XYZ (URDF convention: R = Rz(y) @ Ry(p) @ Rx(r))
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    """Return (xyz, R) of an <origin> child, identity if absent."""
    if elem is None:
        return np.zeros(3), np.eye(3)
    origin = elem.find("origin")
    if origin is None:
        return np.zeros(3), np.eye(3)
    xyz = np.array([float(v) for v in origin.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in origin.get("rpy", "0 0 0").split()]
    return xyz, _rpy_to_matrix(rpy)


@dataclass
class Primitive:
    """One collision/visual primitive in link-local frame."""
    kind: str                   # "box" | "cylinder" | "sphere" | "triangle"
    # box: (sx,sy,sz); cyl: (r, len, 0); sph: (r,0,0);
    # triangle: (a, b, c) with local verts (0,0),(a,0),(b,c) in the z=0 plane
    size: np.ndarray
    xyz: np.ndarray             # triangle: v0
    rot: np.ndarray             # 3x3; triangle: columns [x along e1, y, normal]
    link: str
    semantic_id: int = 0


def _resolve_mesh_path(fname: str, urdf_path: str) -> Optional[str]:
    """Resolve a URDF mesh filename as it is, or relative to the URDF's
    directory; a ``package://pkg/`` prefix is dropped. None when no file is
    found."""
    if not fname:
        return None
    if fname.startswith("package://"):
        fname = fname.split("package://", 1)[1].split("/", 1)[-1]
    base = os.path.dirname(urdf_path) if urdf_path and os.path.sep in urdf_path \
        else (os.path.dirname(urdf_path) or ".")
    for c in (fname, os.path.join(base, fname), os.path.join(base, os.path.basename(fname))):
        if os.path.isfile(c):
            return c
    return None


@dataclass
class UrdfModel:
    path: str
    mass: float
    com: np.ndarray             # in root-link frame
    inertia: np.ndarray         # 3x3 about COM, root-link axes
    links: List[str]
    primitives: List[Primitive]
    bound_radius: float         # bounding-sphere radius about COM (collision proxy)


def _link_world_transforms(root) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Pose of every link in the root-link frame via the joint tree, with
    joint displacements at zero."""
    joints = []
    children = set()
    for j in root.findall("joint"):
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        xyz, R = _parse_origin(j)
        joints.append((parent, child, xyz, R))
        children.add(child)

    link_names = [l.get("name") for l in root.findall("link")]
    roots = [n for n in link_names if n not in children]
    base = roots[0] if roots else link_names[0]

    tfs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {base: (np.zeros(3), np.eye(3))}
    for _ in range(len(joints) + 1):
        for parent, child, xyz, R in joints:
            if parent in tfs and child not in tfs:
                p_xyz, p_R = tfs[parent]
                tfs[child] = (p_xyz + p_R @ xyz, p_R @ R)
    for n in link_names:
        tfs.setdefault(n, (np.zeros(3), np.eye(3)))
    return tfs


def _native_enabled(semantic_masked_links) -> bool:
    return not semantic_masked_links and os.environ.get(
        "AERIAL_GYM_TPU_NATIVE_LOADER", "1") != "0"


def load_urdf(path: str, semantic_id: int = 0, per_link_semantic: bool = False,
              semantic_masked_links: Optional[Dict[str, int]] = None) -> UrdfModel:
    """Parse a URDF file. One that references a mesh takes this module's
    parser (the triangle path); a primitive-only one takes the native
    compiler, unless ``semantic_masked_links`` is given or the compiler
    declines the file."""
    try:
        with open(path) as f:
            has_mesh = "<mesh" in f.read()
    except OSError:
        has_mesh = False
    if not has_mesh and _native_enabled(semantic_masked_links):
        from . import native_loader
        model = native_loader.load_urdf_native(path, semantic_id, per_link_semantic)
        if model is not None:
            return model
    return _parse_urdf_tree(ET.parse(path).getroot(), path, semantic_id, per_link_semantic,
                            semantic_masked_links)


def load_urdf_string(text: str, name: str = "<string>", semantic_id: int = 0,
                     per_link_semantic: bool = False,
                     semantic_masked_links: Optional[Dict[str, int]] = None) -> UrdfModel:
    """Parse URDF text, by the same routing as load_urdf (a mesh filename
    resolves as it is, or relative to ``name``'s directory)."""
    if "<mesh" not in text and _native_enabled(semantic_masked_links):
        from . import native_loader
        model = native_loader.load_urdf_string_native(text, name, semantic_id,
                                                      per_link_semantic)
        if model is not None:
            return model
    return _parse_urdf_tree(ET.fromstring(text), name, semantic_id, per_link_semantic,
                            semantic_masked_links)


def _parse_urdf_tree(root, name: str, semantic_id: int = 0, per_link_semantic: bool = False,
                     semantic_masked_links: Optional[Dict[str, int]] = None) -> UrdfModel:
    tfs = _link_world_transforms(root)
    semantic_masked_links = semantic_masked_links or {}

    total_mass = 0.0
    com_acc = np.zeros(3)
    contribs = []  # (mass, com_world, I_world_about_link_com)
    primitives: List[Primitive] = []

    for link_ctr, link in enumerate(root.findall("link")):
        lname = link.get("name")
        l_xyz, l_R = tfs[lname]

        inertial = link.find("inertial")
        if inertial is not None:
            m = float(inertial.find("mass").get("value"))
            i_xyz, i_R = _parse_origin(inertial)
            com_world = l_xyz + l_R @ i_xyz
            I = np.zeros((3, 3))
            ie = inertial.find("inertia")
            if ie is not None:
                ixx = float(ie.get("ixx", 0)); iyy = float(ie.get("iyy", 0))
                izz = float(ie.get("izz", 0)); ixy = float(ie.get("ixy", 0))
                ixz = float(ie.get("ixz", 0)); iyz = float(ie.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            R_tot = l_R @ i_R
            total_mass += m
            com_acc += m * com_world
            contribs.append((m, com_world, R_tot @ I @ R_tot.T))

        # collision primitives (fall back to visual if no collision geometry)
        geoms = link.findall("collision") or link.findall("visual")
        sem = semantic_masked_links.get(lname, link_ctr) if per_link_semantic else semantic_id
        for g in geoms:
            geom = g.find("geometry")
            if geom is None:
                continue
            g_xyz, g_R = _parse_origin(g)
            p_xyz = l_xyz + l_R @ g_xyz
            p_R = l_R @ g_R
            box, cyl, sph = geom.find("box"), geom.find("cylinder"), geom.find("sphere")
            mesh = geom.find("mesh")
            if box is not None:
                size = np.array([float(v) for v in box.get("size").split()])
                primitives.append(Primitive("box", size, p_xyz, p_R, lname, sem))
            elif cyl is not None:
                r = float(cyl.get("radius")); L = float(cyl.get("length"))
                primitives.append(
                    Primitive("cylinder", np.array([r, L, 0.0]), p_xyz, p_R, lname, sem))
            elif sph is not None:
                r = float(sph.get("radius"))
                primitives.append(
                    Primitive("sphere", np.array([r, 0.0, 0.0]), p_xyz, p_R, lname, sem))
            elif mesh is not None:
                # one triangle primitive per face of the (decimated) mesh; a
                # box of 0.1 x scale when the file cannot be resolved
                scale = np.array([float(v) for v in (mesh.get("scale") or "1 1 1").split()])
                resolved = _resolve_mesh_path(mesh.get("filename", ""), name)
                if resolved:
                    from .mesh import mesh_to_triangle_prims
                    tv0, trot, tsize = mesh_to_triangle_prims(resolved, scale=scale)
                    for k in range(len(tv0)):
                        primitives.append(Primitive("triangle", tsize[k], p_xyz + p_R @ tv0[k],
                                                    p_R @ trot[k], lname, sem))
                else:
                    primitives.append(Primitive("box", 0.1 * scale, p_xyz, p_R, lname, sem))

    com = com_acc / total_mass if total_mass > 0 else np.zeros(3)
    # parallel-axis aggregation about the robot COM
    I_total = np.zeros((3, 3))
    for m, c, I_w in contribs:
        d = c - com
        I_total += I_w + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    # bounding sphere: furthest primitive extent from COM; a triangle's
    # extent is its edge data from v0, not halved
    radius = 0.05
    for p in primitives:
        half = 1.0 if p.kind == "triangle" else 0.5
        ext = float(np.max(np.abs(p.size))) * half + float(np.linalg.norm(p.xyz - com))
        radius = max(radius, ext)

    return UrdfModel(
        path=name,
        mass=total_mass,
        com=com,
        inertia=I_total,
        links=[l.get("name") for l in root.findall("link")],
        primitives=primitives,
        bound_radius=radius,
    )
