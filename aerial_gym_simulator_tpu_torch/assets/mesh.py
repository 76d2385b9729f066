"""Triangle meshes of URDF ``<mesh filename=...>`` assets, as primitives.

Copied from the JAX package's ``assets/mesh.py``. A mesh becomes triangle
primitives (kind 3) in the same tables as the boxes, cylinders and spheres:
each triangle is stored as its own orthonormal frame (origin = v0, x along
edge 1, z along the normal) plus the 2-D vertex data (a, b, c) of its local
vertices (0,0), (a,0), (b,c). That is the (size, pos, rot) record that the
ray-cast kernel's ``test_triangle`` (``csrc/raycast.cu``) and the collision
SDF's ``_sd_triangle`` (``envs/collision.py``) read.

Formats: STL (binary and ASCII) and OBJ (v/f). A mesh larger than the
triangle budget is decimated by vertex clustering: every triangle costs a
narrow-phase test on each ray that the broad phase keeps.

Load-time only; runs once per asset type at build.
"""

from __future__ import annotations

import os
import struct as _struct
from typing import Tuple

import numpy as np

# The per-mesh triangle budget. The JAX package quarters its 2,048 on any
# backend but the TPU (an interpret-mode workaround); the port has no
# backend at load time and takes the accelerator's 2,048. The variable
# pins it in both packages; a caller may also assign this attribute, or
# pass ``budget=`` to mesh_to_triangle_prims.
DEFAULT_TRIANGLE_BUDGET = int(os.environ.get("AERIAL_GYM_TPU_MESH_TRIANGLE_BUDGET", "2048"))


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load (vertices (V,3) f64, faces (F,3) i64) from .stl/.obj."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        return _load_stl(path)
    if ext == ".obj":
        return _load_obj(path)
    raise ValueError(f"unsupported mesh format: {path} (.stl and .obj are supported)")


def _load_stl(path: str):
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # a binary file may start with 'solid' too: look for the keywords
            data = f.read()
            if _ascii_stl_plausible(data):
                return _parse_ascii_stl(data.decode("ascii", "ignore"))
            f.seek(0)
        f.seek(80)
        (n_tri,) = _struct.unpack("<I", f.read(4))
        raw = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
        if raw.size != n_tri * 50:
            raise ValueError(f"truncated binary STL: {path}")
        rec = raw.reshape(n_tri, 50)
        tri = rec[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    verts = tri.reshape(-1, 3).astype(np.float64)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return _weld(verts, faces)


def _ascii_stl_plausible(data: bytes) -> bool:
    return b"facet" in data[:500] and b"vertex" in data


def _parse_ascii_stl(text: str):
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(v) for v in line.split()[1:4]])
    verts = np.asarray(verts, np.float64)
    if len(verts) % 3:
        raise ValueError("ASCII STL vertex count not a multiple of 3")
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return _weld(verts, faces)


def _load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):   # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _weld(verts, faces, tol=1e-9):
    """Merge duplicate vertices (binary STL repeats every vertex)."""
    key = np.round(verts / max(tol, 1e-12)).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return verts[idx], inv.reshape(-1)[faces]


def decimate_vertex_clustering(verts: np.ndarray, faces: np.ndarray, budget: int):
    """Snap vertices to a uniform grid and collapse (vertex clustering),
    coarsening the grid until the triangle count fits the budget; collapsed
    and duplicate triangles are dropped."""
    if len(faces) <= budget:
        return verts, faces
    lo, hi = verts.min(0), verts.max(0)
    diag = float(np.linalg.norm(hi - lo)) or 1.0
    cell = diag / 64.0
    for _ in range(16):
        key = np.floor((verts - lo) / cell).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        # each cluster's vertex: the mean of its members
        rep = np.zeros((len(uniq), 3))
        cnt = np.zeros(len(uniq))
        np.add.at(rep, inv, verts)
        np.add.at(cnt, inv, 1.0)
        rep /= cnt[:, None]
        f = inv[faces]
        keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[keep]
        _, uidx = np.unique(np.sort(f, axis=1), axis=0, return_index=True)
        f = f[np.sort(uidx)]
        if len(f) <= budget:
            return rep, f
        cell *= 1.5
    return rep, f[:budget]


def triangles_to_frames(verts: np.ndarray, faces: np.ndarray):
    """Per-triangle primitive records: (origin (F,3) = v0, rot (F,3,3) whose
    columns are the triangle's axes [x along e1, y in-plane, z normal],
    size (F,3) = (|e1|, e2.x, e2.y)), so the local vertices are (0,0), (a,0),
    (b,c) in the plane z = 0. Degenerate triangles are dropped."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    n = np.cross(e1, e2)
    good = np.linalg.norm(n, axis=1) > 1e-12
    v0, e1, e2, n = v0[good], e1[good], e2[good], n[good]
    a = np.linalg.norm(e1, axis=1)
    x = e1 / a[:, None]
    z = n / np.linalg.norm(n, axis=1)[:, None]
    y = np.cross(z, x)
    rot = np.stack([x, y, z], axis=2)          # columns = frame axes
    b = np.einsum("fi,fi->f", e2, x)
    c = np.einsum("fi,fi->f", e2, y)           # > 0 by construction
    return v0, rot, np.stack([a, b, c], axis=1)


def mesh_to_triangle_prims(path: str, scale=(1.0, 1.0, 1.0), budget: int = None):
    """Load, scale and decimate a mesh file into triangle-primitive arrays
    (origin, rot, size), see triangles_to_frames. ``budget`` None takes
    DEFAULT_TRIANGLE_BUDGET."""
    budget = budget or DEFAULT_TRIANGLE_BUDGET
    verts, faces = load_mesh(path)
    verts = verts * np.asarray(scale, np.float64)
    verts, faces = decimate_vertex_clustering(verts, faces, budget)
    return triangles_to_frames(verts, faces)
