"""Custom task template (the reference's task/custom_task/custom_task.py).

Counterpart of ``aerial_gym_simulator_tpu/tasks/custom_task.py``. Copy this
file, fill in the marked sections, and register your task:

    from aerial_gym_simulator_tpu_torch.registry.registries import task_registry
    task_registry.register_task("my_task", CustomTask, CustomTaskConfig)

The pattern: write the whole RL step (sim step -> reward -> termination ->
masked auto-reset -> observation packing) as one function of the state in
tensor code on the sim's device, reading nothing back to the host. The
built-in tasks (position_setpoint_task.py, navigation_task.py) are complete
worked examples of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..control.controllers import compute_robot_obs
from ..sim import dynamics
from ..sim.sim_builder import SimBuilder
from ..sim.structs import replace


@dataclass
class CustomTaskConfig:
    seed: int = 1
    sim_name: str = "base_sim"
    env_name: str = "empty_env"
    robot_name: str = "base_quadrotor"
    controller_name: str = "lee_velocity_control"
    args: dict = field(default_factory=dict)
    num_envs: int = 64
    use_warp: bool = False
    headless: bool = True
    device: Optional[str] = None          # None: CUDA; "cpu" must be asked for
    observation_space_dim: int = 13
    privileged_observation_space_dim: int = 0
    action_space_dim: int = 4
    episode_len_steps: int = 500


class CustomTask:
    def __init__(self, task_config: CustomTaskConfig, seed=None, num_envs=None,
                 headless=None, device=None, use_warp=None, shard=None):
        if seed is not None:
            task_config.seed = seed
        if num_envs is not None:
            task_config.num_envs = num_envs
        if device is not None:
            task_config.device = device
        self.task_config = task_config

        self.sim_env = SimBuilder().build_env(
            sim_name=task_config.sim_name, env_name=task_config.env_name,
            robot_name=task_config.robot_name, controller_name=task_config.controller_name,
            device=task_config.device, num_envs=task_config.num_envs, seed=task_config.seed,
            shard=shard)
        self.num_envs = self.sim_env.num_envs
        self.shard = shard          # this rank's block of the env axis, or None
        self.params = self.sim_env.params
        self.device = self.sim_env.device
        self.observation_space_dim = task_config.observation_space_dim
        self.action_space_dim = task_config.action_space_dim
        self.infos: Dict = {}
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.task_obs = {
            "observations": zeros(self.num_envs, task_config.observation_space_dim),
            "priviliged_obs": zeros(self.num_envs,
                                    task_config.privileged_observation_space_dim),
            "collisions": zeros(self.num_envs, 1),
            "rewards": zeros(self.num_envs, 1),
        }
        self.rewards = zeros(self.num_envs)
        self.terminations = zeros(self.num_envs)
        self.truncations = zeros(self.num_envs)

    # ------------------------------------------------------------------
    # YOUR TASK LOGIC: edit reward / termination / observations below.
    # Everything stays tensor code on the device.
    # ------------------------------------------------------------------
    def _task_step(self, state, actions):
        state = dynamics.env_step(self.params, state, actions, None)
        obs = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)

        # >>> reward: implement your own <<<
        reward = -torch.linalg.norm(obs.pos, dim=-1)

        truncations = (state.sim_steps > self.task_config.episode_len_steps).to(torch.float32)
        state = replace(state, truncations=truncations)
        state = dynamics.post_reward_step(self.params, state)

        obs2 = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)
        # >>> observations: pack what your policy needs <<<
        task_obs = torch.cat([-obs2.pos, obs2.quat, obs2.body_linvel, obs2.body_angvel],
                             dim=-1)
        return state, task_obs, reward, state.crashes, truncations

    # -- gym API ---------------------------------------------------------
    @property
    def state(self):
        return self.sim_env.state

    def close(self):
        self.sim_env.delete_env()

    def reset(self):
        self.sim_env.reset()
        return self.get_return_tuple()

    def reset_idx(self, env_ids):
        self.sim_env.reset_idx(env_ids)

    def render(self):
        return None

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        state, task_obs, reward, term, trunc = self._task_step(self.sim_env.state, actions)
        self.sim_env.state = state
        self.task_obs["observations"] = task_obs
        self.rewards, self.terminations, self.truncations = reward, term, trunc
        return self.get_return_tuple()

    def get_return_tuple(self):
        return (self.task_obs, self.rewards, self.terminations, self.truncations, self.infos)


# Register your task by uncommenting (the reference's task/__init__.py:133-135):
# from aerial_gym_simulator_tpu_torch.registry.registries import task_registry
# task_registry.register_task("custom_task", CustomTask, CustomTaskConfig)
