"""Deployment: a checkpoint to onboard inference.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/``:

  1. train with the PPO learner (``rl/ppo.py``) and save a checkpoint;
  2. ``export_policy_npz`` writes it as a plain ``.npz``;
  3. ``load_policy_npz`` / ``Sim2RealInferenceClass`` run it on a torch
     device (CUDA unless ``device="cpu"``), ``NumpyPolicy`` /
     ``NumpyRecurrentPolicy`` with numpy alone; ``RL_Nav_Interface`` is
     the reference's navigation interface;
  4. ``ros_node.NavPolicyNode`` streams odometry -> observation -> action
     under rospy, or under ``ros_loopback`` without a ROS installation;
  5. or ``convert_model_to_script_model`` scripts the ``.npz`` into a
     TorchScript ``.pt`` for LibTorch-only onboard stacks.

``import_rl_games_policy`` / ``import_sample_factory_policy`` convert the
reference framework's torch checkpoints into the same ``.npz`` formats.
"""

from .nn_inference_class import Sim2RealInferenceClass
from .numpy_policy import NumpyPolicy
from .policy import export_policy_npz, load_policy_npz
from .sample_factory_inference import RL_Nav_Interface
from .torch_export import convert_model_to_script_model
from .torch_import import (NumpyRecurrentPolicy, import_rl_games_policy,
                           import_sample_factory_policy)

__all__ = [
    "NumpyPolicy",
    "export_policy_npz",
    "load_policy_npz",
    "Sim2RealInferenceClass",
    "RL_Nav_Interface",
    "NumpyRecurrentPolicy",
    "import_rl_games_policy",
    "import_sample_factory_policy",
    "convert_model_to_script_model",
]
