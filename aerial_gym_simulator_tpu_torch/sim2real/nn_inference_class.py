"""Checkpoint inference class.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/nn_inference_class.py``
(after the reference's ``sim2real/nn_inference_class.py:27-110``): the same
call surface, ``get_action(obs, get_np=..., get_robot_zero=...)`` and
``reset(env_ids)``, on the port's ``load_policy_npz``, so the policy runs on
a torch device (CUDA unless ``device="cpu"``). ``get_np=False`` returns a
torch tensor on that device, where the JAX package returns a jax array.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

from .policy import export_policy_npz, load_policy_npz

logger = logging.getLogger("sim2real_inference")


class Sim2RealInferenceClass:
    def __init__(self, num_envs: int, num_actions: int, num_obs: int, checkpoint_path: str,
                 device=None):
        self.num_envs = num_envs
        self.num_actions = num_actions
        self.num_obs = num_obs
        if not checkpoint_path.endswith(".npz"):
            # the port's own training checkpoint: convert it first
            npz = checkpoint_path + ".npz"
            export_policy_npz(checkpoint_path, npz)
            checkpoint_path = npz
        # a recurrent archive gets the GRU runner, an MLP one the plain
        # runner; num_actions resolves a mu-only head
        self.policy = load_policy_npz(checkpoint_path, device=device, num_envs=num_envs,
                                      action_dim=num_actions)
        self.device = self.policy.norm_mean.device
        if self.policy.action_dim != num_actions:
            logger.warning("checkpoint action dim %d != requested %d",
                           self.policy.action_dim, num_actions)
        logger.info("loaded policy from %s on %s", checkpoint_path, self.device)

    def reset(self, env_ids: Optional[Sequence[int]] = None):
        """Zero the recurrent policy's hidden state of ``env_ids`` (all when
        None), as the reference's class resets its RNN states; a
        feed-forward policy has nothing to reset."""
        if hasattr(self.policy, "reset"):
            self.policy.reset(env_ids)

    def get_action(self, obs, get_np: bool = True, get_robot_zero: bool = False):
        """(num_envs, num_obs) or (num_obs,) observations -> actions: a numpy
        array when ``get_np``, else a tensor on the policy's device."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if obs.dim() == 1:
            obs = obs[None]
        actions = self.policy(obs)
        if get_robot_zero:
            actions = actions[0]
        return actions.cpu().numpy() if get_np else actions
