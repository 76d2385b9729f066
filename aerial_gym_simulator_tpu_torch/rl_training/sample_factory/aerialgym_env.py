"""sample-factory integration.

Counterpart of ``aerial_gym_simulator_tpu/rl_training/sample_factory/
aerialgym_env.py`` (the reference's rl_training/sample_factory/
aerialgym_examples/train_aerialgym.py:33-350): registers an aerial-gym
vec-env factory and the tuned parameter overrides with sample-factory.
sample-factory is an optional dependency and is not bundled: the factory,
the overrides and the parser hooks work without it, and the registration
raises an ImportError that says so. The port's own learner (``rl/ppo.py``)
covers the same training natively.

    python -m aerial_gym_simulator_tpu_torch.rl_training.sample_factory.aerialgym_env \
        --env=position_setpoint_task --env_agents=16
"""

from __future__ import annotations

from typing import Optional

try:
    from sample_factory.envs.env_utils import register_env
    from sample_factory.train import run_rl
    from sample_factory.utils.utils import str2bool
    HAVE_SAMPLE_FACTORY = True
except ImportError:
    HAVE_SAMPLE_FACTORY = False

from ..vec_env import AerialGymVecEnv


def make_aerialgym_env(full_task_name: str, cfg=None, env_config=None,
                       render_mode: Optional[str] = None):
    """Env factory in the signature sample-factory expects. ``cfg.env_agents``
    envs (1,024 when unset), on the CPU when ``cfg.device`` is "cpu" (the
    sample-factory flag), on CUDA otherwise."""
    import aerial_gym_simulator_tpu_torch as port

    num_envs = getattr(cfg, "env_agents", None)
    if num_envs is None or num_envs <= 0:
        num_envs = 1024
    device = "cpu" if getattr(cfg, "device", None) == "cpu" else None
    task = port.task_registry.make_task(full_task_name, num_envs=num_envs, device=device)
    return AerialGymVecEnv(task)


# ---------------------------------------------------------------------------
# parameter overrides (the reference's train_aerialgym.py:114-245; pure
# data, importable without sample-factory)
# ---------------------------------------------------------------------------

# defaults shared by every aerial-gym env under sample-factory
SF_BASE_DEFAULTS = dict(
    batched_sampling=True,
    num_workers=1,
    num_envs_per_worker=1,
    worker_num_splits=1,
    train_for_env_steps=10_000_000,
    use_rnn=False,
    adaptive_stddev=True,
    policy_initialization="torch_default",
    env_gpu_actions=True,
    reward_scale=0.1,
    rollout=24,
    max_grad_norm=0.0,
    batch_size=2048,
    num_batches_per_epoch=2,
    num_epochs=4,
    ppo_clip_ratio=0.2,
    value_loss_coeff=2.0,
    exploration_loss_coeff=0.0,
    nonlinearity="elu",
    learning_rate=3e-4,
    lr_schedule="kl_adaptive_epoch",
    lr_schedule_kl_threshold=0.016,
    shuffle_minibatches=True,
    gamma=0.98,
    gae_lambda=0.95,
    with_vtrace=False,
    value_bootstrap=True,
    normalize_input=True,
    normalize_returns=True,
    save_best_after=int(1e5),
    serial_mode=True,
    async_rl=True,
    use_env_info_cache=False,
    kl_loss_coeff=0.1,
    restart_behavior="overwrite",
)

# per-task overrides (the reference's env_configs, train_aerialgym.py:164-245)
SF_ENV_CONFIGS = dict(
    position_setpoint_task=dict(
        train_for_env_steps=131_000_000_000,
        encoder_mlp_layers=[256, 128, 64],
        gamma=0.99, rollout=16, learning_rate=1e-4,
        lr_schedule_kl_threshold=0.016, batch_size=16384, num_epochs=4,
        max_grad_norm=1.0, num_batches_per_epoch=4,
        exploration_loss_coeff=0.0,
    ),
    navigation_task=dict(
        train_for_env_steps=131_000_000_000,
        encoder_mlp_layers=[256, 128, 64],
        use_rnn=True, rnn_num_layers=1, rnn_size=64, rnn_type="gru",
        gamma=0.98, rollout=32, learning_rate=1e-4,
        lr_schedule_kl_threshold=0.016, batch_size=2048, num_epochs=4,
        max_grad_norm=1.0, num_batches_per_epoch=4,
        exploration_loss_coeff=0.0,
    ),
    lidar_navigation_task=dict(
        train_for_env_steps=131_000_000_000,
        encoder_mlp_layers=[256, 128, 64],
        use_rnn=True, rnn_num_layers=1, rnn_size=128, rnn_type="gru",
        gamma=0.98, rollout=32, learning_rate=1e-4,
        lr_schedule_kl_threshold=0.016, batch_size=1024, num_epochs=4,
        max_grad_norm=1.0, num_batches_per_epoch=4,
        exploration_loss_coeff=0.001,
    ),
    radar_navigation_task=dict(
        train_for_env_steps=131_000_000_000,
        encoder_mlp_layers=[256, 128, 64],
        use_rnn=True, rnn_num_layers=1, rnn_size=128, rnn_type="gru",
        gamma=0.98, rollout=32, learning_rate=1e-4,
        lr_schedule_kl_threshold=0.016, batch_size=1024, num_epochs=4,
        max_grad_norm=1.0, num_batches_per_epoch=4,
        exploration_loss_coeff=0.001,
    ),
)


def add_extra_params_func(parser):
    """Extra command-line params (the reference's train_aerialgym.py:73-112)."""
    parser.add_argument("--env_agents", default=-1, type=int,
                        help="num agents per vectorized env")
    parser.add_argument("--obs_key", default="obs", type=str)
    parser.add_argument("--subtask", default=None, type=str)
    parser.add_argument("--eval_stats", default=False,
                        type=(str2bool if HAVE_SAMPLE_FACTORY else bool))


def override_default_params_func(env, parser):
    """Tuned sample-factory defaults per task (the reference's
    train_aerialgym.py:114-162 and env_configs)."""
    parser.set_defaults(**SF_BASE_DEFAULTS)
    if env in SF_ENV_CONFIGS:
        parser.set_defaults(**SF_ENV_CONFIGS[env])


def register_aerialgym_custom_components():
    """Register every registered task as a sample-factory env (the
    reference's train_aerialgym.py registration block)."""
    if not HAVE_SAMPLE_FACTORY:
        raise ImportError(
            "sample-factory is not installed; either `pip install sample-factory` in your "
            "own environment or use the port's PPO learner "
            "(aerial_gym_simulator_tpu_torch.rl.ppo).")
    import aerial_gym_simulator_tpu_torch as port

    for name in port.task_registry.get_task_names():
        register_env(name, make_aerialgym_env)


def main():
    """Train with sample-factory (requires it installed)."""
    register_aerialgym_custom_components()
    import sys

    from sample_factory.cfg.arguments import parse_full_cfg, parse_sf_args

    parser, partial_cfg = parse_sf_args(argv=sys.argv[1:], evaluation=False)
    add_extra_params_func(parser)
    override_default_params_func(getattr(partial_cfg, "env", None), parser)
    cfg = parse_full_cfg(parser, argv=sys.argv[1:])
    run_rl(cfg)


if __name__ == "__main__":
    main()
