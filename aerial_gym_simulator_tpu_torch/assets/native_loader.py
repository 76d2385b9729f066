"""ctypes binding of the native URDF scene compiler (``csrc/scene_compiler.cpp``).

Counterpart of the JAX package's ``assets/native_loader.py``. The shared
library is built at first use by the host C++ compiler into ``_build/``
(``ops/_build.HostLibrary``). A failed build raises with the compiler's
log; nothing switches to the Python parser on its own. A URDF that the
compiler declines (a parse error, more than ``MAX_PRIMS`` primitives)
returns None, and the caller parses it with ``assets/urdf.py``, whose
contract the compiler shares.
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional

import numpy as np

from ..ops._build import HostLibrary
from . import urdf as pyurdf

logger = logging.getLogger(__name__)

LIBRARY = HostLibrary("scene_compiler")
MAX_PRIMS = 256          # primitives per model; a larger one is declined

_lib = None
_KIND_NAMES = {0: "box", 1: "cylinder", 2: "sphere"}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = LIBRARY.load()
        i, ip, fp = ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        # (n_prims, kind, size, pos, rot, semantic, mass, com, inertia, bound_radius)
        outs = [ip, ip, fp, fp, fp, ip, fp, fp, fp, fp]
        for fn in (lib.agtpu_compile_urdf, lib.agtpu_compile_urdf_string):
            fn.argtypes = [ctypes.c_char_p, i, i, i] + outs
            fn.restype = i
        lib.agtpu_compile_urdf_batch.argtypes = [ctypes.c_char_p, i, i, i, i] + outs + [i]
        lib.agtpu_compile_urdf_batch.restype = i
        lib.agtpu_version.argtypes = []
        lib.agtpu_version.restype = ctypes.c_char_p
        logger.debug("native scene compiler: %s", lib.agtpu_version().decode())
        _lib = lib
    return _lib


def _to_model(path, n, kind, size, pos, rot, sem, mass, com, inertia,
              bound_radius) -> pyurdf.UrdfModel:
    prims = [pyurdf.Primitive(kind=_KIND_NAMES[int(kind[i])],
                              size=np.array(size[i], dtype=np.float64),
                              xyz=np.array(pos[i], dtype=np.float64),
                              rot=np.array(rot[i], dtype=np.float64).reshape(3, 3),
                              link="", semantic_id=int(sem[i]))
             for i in range(n)]
    return pyurdf.UrdfModel(path=path, mass=float(mass), com=np.asarray(com, np.float64),
                            inertia=np.asarray(inertia, np.float64).reshape(3, 3),
                            links=[], primitives=prims, bound_radius=float(bound_radius))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _buffers(F: int):
    """Output slabs of F models of MAX_PRIMS primitives each."""
    M = MAX_PRIMS
    return dict(n=np.zeros((F,), np.int32), kind=np.zeros((F, M), np.int32),
                size=np.zeros((F, M, 3), np.float32), pos=np.zeros((F, M, 3), np.float32),
                rot=np.zeros((F, M, 9), np.float32), sem=np.zeros((F, M), np.int32),
                mass=np.zeros((F,), np.float32), com=np.zeros((F, 3), np.float32),
                inertia=np.zeros((F, 9), np.float32), radius=np.zeros((F,), np.float32))


def _args(b: dict):
    i, f = ctypes.c_int, ctypes.c_float
    return (_ptr(b["n"], i), _ptr(b["kind"], i), _ptr(b["size"], f), _ptr(b["pos"], f),
            _ptr(b["rot"], f), _ptr(b["sem"], i), _ptr(b["mass"], f), _ptr(b["com"], f),
            _ptr(b["inertia"], f), _ptr(b["radius"], f))


def _model(b: dict, k: int, path: str) -> pyurdf.UrdfModel:
    return _to_model(path, int(b["n"][k]), b["kind"][k], b["size"][k], b["pos"][k],
                     b["rot"][k], b["sem"][k], b["mass"][k], b["com"][k], b["inertia"][k],
                     b["radius"][k])


def _compile_one(fn, first_arg: bytes, name: str, semantic_id: int,
                 per_link_semantic: bool) -> Optional[pyurdf.UrdfModel]:
    b = _buffers(1)
    rc = fn(first_arg, semantic_id, int(per_link_semantic), MAX_PRIMS, *_args(b))
    return _model(b, 0, name) if rc == 0 else None


def load_urdf_native(path: str, semantic_id: int = 0,
                     per_link_semantic: bool = False) -> Optional[pyurdf.UrdfModel]:
    """Compile one URDF file; None when the compiler declines it."""
    return _compile_one(_load().agtpu_compile_urdf, path.encode(), path, semantic_id,
                        per_link_semantic)


def load_urdf_string_native(text: str, name: str = "<string>", semantic_id: int = 0,
                            per_link_semantic: bool = False) -> Optional[pyurdf.UrdfModel]:
    """Compile URDF text (the procedural-asset path); None when the compiler
    declines it."""
    return _compile_one(_load().agtpu_compile_urdf_string, text.encode(), name, semantic_id,
                        per_link_semantic)


def load_urdf_batch(paths: List[str], semantic_id: int = 0, per_link_semantic: bool = False,
                    num_threads: int = 0) -> Optional[List[pyurdf.UrdfModel]]:
    """Compile many URDF files on ``num_threads`` threads (0: one per core);
    None when the list is empty or the compiler declines any of them."""
    if not paths:
        return None
    lib = _load()
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    b = _buffers(len(paths))
    fails = lib.agtpu_compile_urdf_batch(blob, len(paths), semantic_id, int(per_link_semantic),
                                         MAX_PRIMS, *_args(b), num_threads)
    if fails:
        logger.warning("native batch compile: %d of %d files declined", fails, len(paths))
        return None
    return [_model(b, k, p) for k, p in enumerate(paths)]
