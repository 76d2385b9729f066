"""RL training adapters (the reference's aerial_gym/rl_training/), the
counterpart of the JAX package's ``rl_training/``.

Three entry styles, mirroring the reference's rl-games / CleanRL /
sample-factory integrations:

  * ``rl_games/runner.py`` - YAML-configured train/play command line
  * ``cleanrl/ppo_continuous_action.py`` - single-file PPO script
  * ``sample_factory/aerialgym_env.py`` - vec-env adapter (sample-factory
    is optional and not bundled; its registration raises without it)

Each trains with the port's own learner (``rl/ppo.py``).
"""
