"""YAML-configured PPO train/play runner.

Counterpart of ``aerial_gym_simulator_tpu/rl_training/rl_games/runner.py``,
with the command line of the reference's rl-games runner
(rl_training/rl_games/runner.py:172-349): ``--task``, ``--num_envs``,
``--checkpoint``, ``--train`` / ``--play``, ``--file <yaml>``, ``--seed``,
and ``--cpu`` (the default device is CUDA). Hyperparameters are read from
rl-games-layout YAML files (``params.config.*``), so the reference's
shipped configs translate directly; copies of the two the JAX package
ships sit beside this file.

The learner is the port's own PPO (``rl/ppo.py``); there is no rl-games
dependency. PyYAML is imported only when a YAML file is read; where it is
not installed, the rl-games layout's subset of YAML (block mappings, plain
scalars, flow lists, comments) is read by ``parse_simple_yaml``: the YAML
files shipped beside this file must stay inside that subset (the tests read
each with both readers and compare).

    python -m aerial_gym_simulator_tpu_torch.rl_training.rl_games.runner \
        --num_envs 8192 --checkpoint quad.ckpt
    python -m aerial_gym_simulator_tpu_torch.rl_training.rl_games.runner \
        --play --checkpoint quad.ckpt
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
import warnings
from typing import Optional

import torch

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


def load_yaml_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return parse_simple_yaml(text)
    return yaml.safe_load(text)


_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")


def _scalar(text: str):
    """A plain scalar as PyYAML's YAML 1.1 rules read it: null, booleans,
    integers, floats with a point (``1e-4`` stays a string), else the
    string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    low = t.lower()
    if low in ("", "~", "null"):
        return None
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    return t


def parse_simple_yaml(text: str) -> dict:
    """The rl-games config layout without PyYAML: nested block mappings by
    indentation, ``key: value`` with plain or quoted scalars and ``[a, b]``
    flow lists, ``#`` comments. Anything else (block sequences, flow
    mappings, anchors, tags, multi-line scalars) raises ValueError."""
    root: dict = {}
    stack = [(-1, root)]                  # (indent, mapping) of the open blocks
    for n, raw in enumerate(text.splitlines(), 1):
        line = "" if raw.lstrip().startswith("#") else raw.split(" #", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        value = value.strip()
        if not sep or key[:1] in ("-", "&", "*", "!", "?") or value[:1] in ("|", ">", "&",
                                                                            "*", "!", "{"):
            raise ValueError(f"line {n}: {raw.strip()!r} is outside the YAML subset read "
                             f"without PyYAML")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if not value:
            parent[key] = {}
            stack.append((indent, parent[key]))
        elif value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"line {n}: a flow list must close on its line")
            inner = value[1:-1].strip()
            parent[key] = [_scalar(x) for x in inner.split(",")] if inner else []
        else:
            parent[key] = _scalar(value)
    return _nulls(root)


def _nulls(tree):
    """A key with nothing under it is null, as YAML reads ``key:``."""
    if isinstance(tree, dict):
        return {k: (None if v == {} else _nulls(v)) for k, v in tree.items()}
    return tree


def _map_lr_schedule(value):
    if value is None:
        return "fixed"          # rl-games: no schedule key is a constant lr
    if value == "adaptive":
        return "adaptive"
    warnings.warn(f"lr_schedule {value!r} is not implemented (supported: adaptive); "
                  f"training with a constant lr")
    return "fixed"


def ppo_config_from_yaml(doc: dict, num_envs: Optional[int] = None,
                         seed: Optional[int] = None, world: int = 1):
    """Map an rl-games-layout YAML (params.config.*) onto PPOConfig.

    ``world``: the number of ranks the run is sharded over. rl-games'
    multi-GPU mode runs the YAML as written on every rank, so its
    ``minibatch_size`` is one rank's and the global minibatch is ``world``
    times it (gradients averaged over the ranks). ``num_envs`` is the global
    count. ``rnn.before_mlp: True`` (the core before the MLP) is refused:
    the port builds the core after it."""
    from ...rl.ppo import PPOConfig

    if world < 1:
        raise ValueError(f"world {world} < 1")
    p = doc.get("params", doc)
    c = p.get("config", {})
    mlp = p.get("network", {}).get("mlp", {})
    rnn = p.get("network", {}).get("rnn", {}) or {}
    if rnn.get("before_mlp"):
        raise ValueError("rnn.before_mlp: True is not built by the port (its GRU core runs "
                         "after the MLP)")
    horizon = int(c.get("horizon_length", 32))
    envs = int(num_envs or c.get("env_config", {}).get("num_envs",
                                                       c.get("num_actors", 4096)))
    reward_shaper = c.get("reward_shaper", {}) or {}
    return PPOConfig(
        num_envs=envs,
        horizon=horizon,
        minibatch_size=min(world * int(c.get("minibatch_size", 8192)), envs * horizon),
        epochs=int(c.get("mini_epochs", 4)),
        gamma=float(c.get("gamma", 0.99)),
        gae_lambda=float(c.get("tau", 0.95)),
        clip_eps=float(c.get("e_clip", 0.2)),
        value_coef=float(c.get("critic_coef", 2.0)),
        entropy_coef=float(c.get("entropy_coef", 0.0)),
        lr=float(c.get("learning_rate", 3e-4)),
        # rl-games schedule semantics: absent/None -> constant lr, "adaptive"
        # -> KL-driven (the shipped configs' choice); other values (e.g.
        # "linear") are not implemented -> a warning and a constant lr
        lr_schedule=_map_lr_schedule(c.get("lr_schedule")),
        kl_threshold=float(c.get("kl_threshold", 0.016)),
        total_env_steps=int(c.get("max_epochs", 400)) * envs * horizon,
        hidden=tuple(mlp.get("units", [256, 128, 64])),
        activation=mlp.get("activation", "elu"),
        normalize_advantage=bool(c.get("normalize_advantage", True)),
        normalize_obs=bool(c.get("normalize_input", False)),
        normalize_value=bool(c.get("normalize_value", False)),
        value_bootstrap=bool(c.get("value_bootstrap", True)),
        bounds_loss_coef=float(c.get("bounds_loss_coef", 0.0001)),
        # rl-games truncate_grads=False means no gradient clipping at all
        max_grad_norm=(float(c.get("grad_norm", 1.0))
                       if bool(c.get("truncate_grads", True)) else 1e9),
        reward_scale=float(reward_shaper.get("scale_value", 1.0)),
        # the rl-games rnn section (the reference's
        # ppo_aerial_quad_navigation.yaml: gru, 32 units) maps onto the
        # recurrent PPO path
        rnn=("gru" if rnn.get("name") == "gru" else None),
        rnn_hidden=int(rnn.get("units", 256)),
        rnn_layer_norm=bool(rnn.get("layer_norm", False)),
        seed=int(seed if seed is not None else p.get("seed", 42)),
    )


def get_args(argv=None):
    p = argparse.ArgumentParser("aerial_gym_simulator_tpu_torch rl runner")
    p.add_argument("--task", default=None, help="task name (overrides the yaml env_name)")
    p.add_argument("--file", default=os.path.join(CONFIG_DIR, "ppo_aerial_quad.yaml"))
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--train", dest="train", action="store_true", default=True)
    p.add_argument("--play", dest="train", action="store_false")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--play_steps", type=int, default=500)
    p.add_argument("--logdir", default=None, help="TensorBoard + metrics.jsonl directory")
    p.add_argument("--track", default=None, choices=[None, "wandb"],
                   help="stream metrics to wandb (the reference runner's --track)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p.parse_args(argv)


def run(args) -> dict:
    import aerial_gym_simulator_tpu_torch as port
    from ...rl.ppo import PPOTrainer
    from ..vec_env import ExtractObsWrapper

    doc = load_yaml_config(args.file)
    cfg = ppo_config_from_yaml(doc, num_envs=args.num_envs, seed=args.seed)
    if args.total_steps:
        cfg.total_env_steps = args.total_steps
    task_name = args.task or doc.get("params", {}).get("config", {}).get(
        "env_name", "position_setpoint_task")

    task = port.task_registry.make_task(task_name, num_envs=cfg.num_envs, seed=cfg.seed,
                                        device="cpu" if args.cpu else None)
    trainer = PPOTrainer(task, cfg)
    if args.checkpoint and os.path.exists(args.checkpoint):
        trainer.load_checkpoint(args.checkpoint)

    if args.train:
        history = trainer.train(logdir=args.logdir, track=args.track)
        ckpt = args.checkpoint or os.path.join(tempfile.gettempdir(), f"{task_name}_ppo.ckpt")
        trainer.save_checkpoint(ckpt)
        return {"history": history, "checkpoint": ckpt}

    # play: the deterministic policy through the gym API; the reward is
    # summed on the device and read back once
    env = ExtractObsWrapper(task)
    obs = env.reset()
    total_reward = torch.zeros((), device=task.device)
    dones = None            # a recurrent policy zeroes an env's hidden after its episode
    for _ in range(args.play_steps):
        action = trainer.act(obs, deterministic=True, done_prev=dones)
        obs, rew, dones, infos = env.step(action)
        total_reward += rew.mean()
    return {"mean_step_reward": float(total_reward) / args.play_steps}


def main(argv=None):
    out = run(get_args(argv))
    if "history" in out:
        last = out["history"][-1]
        print(f"train done: reward {last['reward_mean']:.3f} "
              f"steps/s {last['env_steps_per_s']:.0f} ckpt {out['checkpoint']}")
    else:
        print(f"play done: mean step reward {out['mean_step_reward']:.3f}")
    return out


if __name__ == "__main__":
    main()
