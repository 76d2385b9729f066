"""Carry parameters and state across from nested numpy dicts.

The dicts are keyed by the record field names (the JAX package's
dataclass field names, which the port keeps), with numpy arrays or Python
scalars as leaves and nested dicts for nested records. This is how a state
reached by another implementation is continued here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .structs import (
    ControllerParams,
    EnvParams,
    MotorParams,
    RaySensorParams,
    RobotParams,
    SceneParams,
    SimParams,
    SimState,
)

_INT64_FIELDS = {"env_prim_slot"}   # used as gather indices


def record_to_numpy(obj):
    """A dataclass record (this package's or any framework's) -> nested
    dict with numpy leaves; None and Python scalars pass through."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: record_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, torch.Generator):
        return None
    return np.asarray(obj)


def _record(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.type == "Tensor":
            arr = np.array(v)  # a writable copy
            if arr.dtype.kind in "iu":
                dtype = torch.int64 if f.name in _INT64_FIELDS else torch.int32
            elif arr.dtype.kind == "b":
                dtype = torch.bool
            else:
                dtype = torch.float32
            kw[f.name] = torch.as_tensor(arr, device=device).to(dtype).contiguous()
        elif f.type == "float":
            kw[f.name] = float(np.float32(v))
        elif f.type in ("int", "bool"):
            kw[f.name] = {"int": int, "bool": bool}[f.type](v)
        else:
            kw[f.name] = v
    return cls(**kw)


def params_from_numpy(d: dict, device) -> SimParams:
    """Nested dict of numpy leaves -> SimParams on ``device`` (rigid robots,
    optional obstacle scene and camera)."""
    for unported in ("dof", "art", "lidar", "imu"):
        if d.get(unported) is not None:
            raise NotImplementedError(f"SimParams.{unported} is not ported yet")
    opt = lambda cls, key: None if d.get(key) is None else _record(cls, d[key], device)
    return SimParams(
        dt=float(np.float32(d["dt"])),
        gravity=torch.as_tensor(np.array(d["gravity"], np.float32), device=device),
        robot=_record(RobotParams, d["robot"], device),
        motor=_record(MotorParams, d["motor"], device),
        controller=_record(ControllerParams, d["controller"], device),
        env=_record(EnvParams, d["env"], device),
        scene=opt(SceneParams, "scene"),
        camera=opt(RaySensorParams, "camera"),
    )


def state_from_numpy(d: dict, device, seed: int = 0) -> SimState:
    """Nested dict of numpy leaves -> SimState on ``device``. A JAX ``rng``
    leaf (per-env keys) is dropped; the state gets a torch.Generator on
    ``device`` seeded with ``seed`` instead."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = dict(d, rng=gen)
    kw = {}
    for f in dataclasses.fields(SimState):
        v = d[f.name]
        if f.name == "rng":
            kw[f.name] = v
            continue
        arr = np.array(v)  # a writable copy
        dtype = torch.int32 if arr.dtype.kind in "iu" else torch.float32
        kw[f.name] = torch.as_tensor(arr, device=device).to(dtype).contiguous()
    return SimState(**kw)
