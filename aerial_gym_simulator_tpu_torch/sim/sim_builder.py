"""SimBuilder — the construction entry point: compose a sim, env, robot and
controller by name into an EnvManager."""

from __future__ import annotations

from typing import Optional

from ..registry.registries import (
    controller_registry,
    env_config_registry,
    robot_registry,
    sim_config_registry,
)
from ..utils.device import resolve_device
from .env_manager import EnvManager
from .params import build_sim_params


class SimBuilder:
    def __init__(self):
        self.env_manager: Optional[EnvManager] = None

    def build_env(self, sim_name: str, env_name: str, robot_name: str,
                  controller_name: str, device=None, num_envs: Optional[int] = None,
                  seed: int = 0, shard=None) -> EnvManager:
        """``device=None`` means CUDA; without a GPU, pass device='cpu'.

        ``shard`` (a ``parallel.mesh.EnvShard`` of ``num_envs`` global envs)
        builds this rank's block alone: the scene's per-env tables cut on the
        host, the state allocated at the block, and the state's generator
        told of the shard before its first draw, so every env holds what
        the same rows of the whole build hold."""
        dev = resolve_device(device)
        sim_cfg = sim_config_registry.make(sim_name)
        env_cfg = env_config_registry.make(env_name)
        robot_cfg = robot_registry.make(robot_name)
        ctrl_cfg = controller_registry.make(controller_name)
        if controller_name == "no_control":
            ctrl_cfg.num_actions = robot_cfg.control_allocator_config.num_motors
        n = num_envs or env_cfg.num_envs
        if shard is not None and shard.n_global != n:
            raise ValueError(f"shard of {shard.n_global} envs for an env of {n}")

        scene = None
        if env_cfg.asset_counts:
            from ..envs.scene import build_scene_params
            scene = build_scene_params(env_cfg, n, dev, shard=shard)

        params = build_sim_params(sim_cfg, env_cfg, robot_cfg, ctrl_cfg, dev,
                                  num_envs=n if shard is None else shard.n_local, scene=scene)
        self.env_manager = EnvManager(params, seed=seed, sim_config=sim_cfg,
                                      env_config=env_cfg, robot_config=robot_cfg,
                                      controller_config=ctrl_cfg, shard=shard)
        return self.env_manager

    def delete_env(self):
        if self.env_manager is not None:
            self.env_manager.delete_env()
            self.env_manager = None
