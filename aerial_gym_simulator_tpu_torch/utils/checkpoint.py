"""Save and restore any state record of the port to one file.

Counterpart of ``aerial_gym_simulator_tpu/utils/checkpoint.py``. A state
here is a dataclass record (``SimState``, ``NavState``, ``LidarNavState``,
``VariantCarry``), a tuple or list of them, a dict of tensors, or any
nesting of these with Python scalars. It is written as a plain structure
(``to_plain``): records become dicts of their fields tagged with the
record's name, tensors are copied to the CPU, and each ``torch.Generator``
(which cannot be pickled) becomes its ``get_state()`` together with its
device. No class is pickled, so the file loads with ``weights_only=True``,
and a record that gained a field since the file was written fails the
``like`` check instead of loading half a state.

The restore reproduces trajectories exactly: every generator of the state
is in the file. A generator is restored onto a generator of the same
device type only: a CPU generator's state (a Mersenne twister) cannot seed
a CUDA generator (a seed and a Philox offset), and the other way round.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
from typing import Any

import torch

logger = logging.getLogger(__name__)

_RECORD = "__record__"
_GENERATOR = "__generator__"
_GENERATOR_REF = "__generator_ref__"
_SCALARS = (type(None), bool, int, float, str)


def to_plain(state: Any, _seen=None) -> Any:
    """A state -> nested dicts, tuples and lists of CPU tensors, generator
    states and Python scalars. A generator met twice is stored once and
    referenced after, so the restored state shares one generator there
    too."""
    seen = {} if _seen is None else _seen
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, torch.Generator):
        if id(state) in seen:
            return {_GENERATOR_REF: seen[id(state)]}
        seen[id(state)] = len(seen)
        return {_GENERATOR: str(state.device), "id": seen[id(state)],
                "state": state.get_state()}
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        out = {_RECORD: type(state).__name__}
        out.update({f.name: to_plain(getattr(state, f.name), seen)
                    for f in dataclasses.fields(state)})
        return out
    if isinstance(state, dict):
        return {k: to_plain(v, seen) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(to_plain(v, seen) for v in state)
    if isinstance(state, _SCALARS):
        return state
    raise TypeError(f"cannot save a {type(state).__name__} in a state checkpoint")


def _mismatch(where: str, what: str):
    return ValueError(f"checkpoint structure does not match template at {where}: {what}")


def _restore_generator(plain, device, seen, where):
    if _GENERATOR_REF in plain:
        return seen[plain[_GENERATOR_REF]]
    saved = torch.device(plain[_GENERATOR])
    if device is None:
        device = saved
    elif torch.device(device).type != saved.type:
        raise ValueError(
            f"{where}: a generator saved on {saved.type} cannot be restored on "
            f"{torch.device(device).type} (their states are different streams)")
    gen = torch.Generator(device=device)
    gen.set_state(plain["state"].cpu())
    seen[plain["id"]] = gen
    return gen


def from_plain(plain: Any, like: Any = None, where: str = "state", _seen=None) -> Any:
    """The inverse of ``to_plain``. With ``like`` the result takes its
    structure, records and devices, and every tensor's shape and dtype is
    checked against it (ValueError on a mismatch); without it records come
    back as dicts of their fields."""
    seen = {} if _seen is None else _seen
    is_dict = isinstance(plain, dict)
    if is_dict and (_GENERATOR in plain or _GENERATOR_REF in plain):
        if like is not None and not isinstance(like, torch.Generator):
            raise _mismatch(where, f"a generator where the template has a {type(like).__name__}")
        return _restore_generator(plain, None if like is None else like.device, seen, where)
    if like is None:
        if is_dict:
            return {k: from_plain(v, None, f"{where}.{k}", seen) for k, v in plain.items()
                    if k != _RECORD}
        if isinstance(plain, (tuple, list)):
            return type(plain)(from_plain(v, None, f"{where}[{i}]", seen)
                               for i, v in enumerate(plain))
        return plain
    if isinstance(like, torch.Tensor):
        if not isinstance(plain, torch.Tensor):
            raise _mismatch(where, f"a {type(plain).__name__} where the template has a tensor")
        if plain.shape != like.shape or plain.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {where} is {tuple(plain.shape)} {plain.dtype}, "
                             f"the template's {tuple(like.shape)} {like.dtype}")
        return plain.to(like.device)
    if isinstance(like, torch.Generator):
        raise _mismatch(where, f"a {type(plain).__name__} where the template has a generator")
    if dataclasses.is_dataclass(like):
        names = [f.name for f in dataclasses.fields(like)]
        if not is_dict or plain.get(_RECORD) != type(like).__name__:
            raise _mismatch(where, f"expected a {type(like).__name__} record")
        if set(plain) - {_RECORD} != set(names):
            raise _mismatch(where, f"{type(like).__name__} fields {sorted(names)}, saved "
                                   f"{sorted(set(plain) - {_RECORD})}")
        return dataclasses.replace(like, **{
            n: from_plain(plain[n], getattr(like, n), f"{where}.{n}", seen) for n in names})
    if isinstance(like, dict):
        if not is_dict or _RECORD in plain or set(plain) != set(like):
            raise _mismatch(where, f"keys {sorted(map(str, like))}")
        return {k: from_plain(plain[k], v, f"{where}.{k}", seen) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if type(plain) is not type(like) or len(plain) != len(like):
            raise _mismatch(where, f"a {type(like).__name__} of {len(like)}")
        return type(like)(from_plain(p, l, f"{where}[{i}]", seen)
                          for i, (p, l) in enumerate(zip(plain, like)))
    if not isinstance(plain, _SCALARS):
        raise _mismatch(where, f"a {type(plain).__name__} where the template has a scalar")
    return plain


def _first_device(state):
    if isinstance(state, (torch.Tensor, torch.Generator)):
        return state.device
    if dataclasses.is_dataclass(state):
        state = [getattr(state, f.name) for f in dataclasses.fields(state)]
    elif isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for v in state:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


def atomic_save(obj: Any, path: str):
    """``torch.save`` to a temporary file beside ``path``, then
    ``os.replace``: a crash mid-save never leaves a half-written file under
    the final name."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.", suffix=".tmp",
                               dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise


def save_state(path: str, state: Any):
    """Write any state (records, tuples, dicts of tensors, generators) to
    ``path``, atomically."""
    atomic_save(to_plain(state), path)
    logger.info("state checkpoint saved to %s", path)


def load_state(path: str, like: Any = None) -> Any:
    """Read a state written by ``save_state``. With ``like`` (a state of the
    same structure) the result is rebuilt in its records on its device, its
    structure and every tensor's shape checked (ValueError on a mismatch);
    without it, nested dicts on the CPU."""
    device = _first_device(like) if like is not None else None
    plain = torch.load(path, map_location=device or "cpu", weights_only=True)
    return from_plain(plain, like)
