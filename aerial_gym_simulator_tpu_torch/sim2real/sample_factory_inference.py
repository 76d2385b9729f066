"""Navigation policy deployment interface.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/sample_factory_inference.py``
(after the reference's ``sim2real/sample_factory_inference.py:98-110``
``RL_Nav_Interface``), on a torch device (CUDA unless ``device="cpu"``)."""

from __future__ import annotations

from .nn_inference_class import Sim2RealInferenceClass

NUM_NAV_OBS = 17 + 64      # state dims + VAE latents (navigation task)
NUM_NAV_ACTIONS = 4


class RL_Nav_Interface:
    def __init__(self, num_envs: int = 1, checkpoint_path: str = "",
                 num_obs: int = NUM_NAV_OBS, num_actions: int = NUM_NAV_ACTIONS, device=None):
        self.model = Sim2RealInferenceClass(
            num_envs=num_envs, num_actions=num_actions, num_obs=num_obs,
            checkpoint_path=checkpoint_path, device=device)

    def step(self, obs: dict):
        """The task's observation dict -> actions as a numpy array."""
        return self.model.get_action(obs["observations"], get_np=True)

    def reset(self, env_ids=(0,)):
        self.model.reset(env_ids)
