"""Command-line and config helpers (reference utils/helpers.py).

Counterpart of ``aerial_gym_simulator_tpu/utils/helpers.py``: ``get_args``
is the reference's gymutil-style parser (task, env, robot and controller
names, num_envs, seed, the headless / use_warp switches);
``update_task_config_from_args`` applies the standard overrides;
``class_to_dict`` flattens config objects for logging and serialization.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict


def get_args(argv=None, extras=()):
    """The standard command line (reference utils/helpers.py:92-160
    parse_arguments); ``extras`` is a sequence of (flag, add_argument
    kwargs)."""
    p = argparse.ArgumentParser("aerial_gym_simulator_tpu_torch")
    p.add_argument("--task", type=str, default=None)
    p.add_argument("--sim_name", type=str, default=None)
    p.add_argument("--env_name", type=str, default=None)
    p.add_argument("--robot_name", type=str, default=None)
    p.add_argument("--controller_name", type=str, default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--headless", action="store_true", default=None)
    p.add_argument("--use_warp", action="store_true", default=None)
    for name, kwargs in extras:
        p.add_argument(name, **kwargs)
    return p.parse_args(argv)


def update_task_config_from_args(task_config, args):
    """Apply command-line overrides onto a task config (the reference's
    update_cfg_from_args: only explicitly passed values win)."""
    for field in ("seed", "num_envs", "headless", "use_warp",
                  "sim_name", "env_name", "robot_name", "controller_name"):
        v = getattr(args, field, None)
        if v is not None and hasattr(task_config, field):
            setattr(task_config, field, v)
    return task_config


def class_to_dict(obj: Any) -> Dict:
    """Recursively flatten a config object or dataclass to plain dicts
    (reference helpers.py:38-54)."""
    if isinstance(obj, dict):
        return {k: class_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(class_to_dict(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return {k: class_to_dict(v) for k, v in vars(obj).items()
                if not k.startswith("_")}
    return obj
