"""Single-file PPO training script (CleanRL style).

Counterpart of ``aerial_gym_simulator_tpu/rl_training/cleanrl/
ppo_continuous_action.py`` (the reference's
rl_training/cleanrl/ppo_continuous_action.py): one runnable file, argparse
flags, optional metrics logging, checkpoint save/load. The rollout storage,
GAE and the PPO update are the port's learner (``rl/ppo.py``) with CleanRL's
semantics: a fixed learning rate, truncations treated as terminals (no
bootstrap), no bounds loss and no value normalization.

    python -m aerial_gym_simulator_tpu_torch.rl_training.cleanrl.ppo_continuous_action \
        --task position_setpoint_task --num_envs 8192 --total_steps 50000000
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="position_setpoint_task")
    p.add_argument("--exp_name", default="ppo_aerial")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num_envs", type=int, default=8192)
    p.add_argument("--total_steps", type=int, default=50_000_000)
    p.add_argument("--num_steps", type=int, default=32, help="rollout horizon per env")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae_lambda", type=float, default=0.95)
    p.add_argument("--update_epochs", type=int, default=4)
    p.add_argument("--minibatch_size", type=int, default=8192)
    p.add_argument("--clip_coef", type=float, default=0.2)
    p.add_argument("--ent_coef", type=float, default=0.0)
    p.add_argument("--vf_coef", type=float, default=2.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--reward_scale", type=float, default=0.1)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--save_path", default=None)
    p.add_argument("--track", action="store_true",
                   help="write the scalars (metrics.jsonl, and TensorBoard where it imports)")
    p.add_argument("--log_dir", default=os.path.join(tempfile.gettempdir(), "aerial_gym_tb"))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from aerial_gym_simulator_tpu_torch.utils.metrics import MetricsWriter

    task = port.task_registry.make_task(args.task, num_envs=args.num_envs, seed=args.seed,
                                        device="cpu" if args.cpu else None)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        horizon=args.num_steps,
        minibatch_size=min(args.minibatch_size, args.num_envs * args.num_steps),
        epochs=args.update_epochs,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        clip_eps=args.clip_coef,
        value_coef=args.vf_coef,
        entropy_coef=args.ent_coef,
        lr=args.learning_rate,
        # CleanRL semantics: a constant lr (the reference script's anneal_lr
        # is a linear decay, not rl-games' adaptive KL schedule), truncation
        # treated as terminal (no timeout bootstrap), no rl-games bounds loss
        # or value normalization
        lr_schedule="fixed",
        value_bootstrap=False,
        bounds_loss_coef=0.0,
        normalize_value=False,
        max_grad_norm=args.max_grad_norm,
        total_env_steps=args.total_steps,
        reward_scale=args.reward_scale,
        seed=args.seed,
    )
    trainer = PPOTrainer(task, cfg)
    if args.checkpoint and os.path.exists(args.checkpoint):
        trainer.load_checkpoint(args.checkpoint)

    history = trainer.train()

    if args.track:
        run_name = f"{args.task}__{args.exp_name}__{args.seed}__{int(time.time())}"
        with MetricsWriter(os.path.join(args.log_dir, run_name)) as writer:
            for m in history:
                writer.write(m["env_steps"], {
                    f"charts/{k}": m[k] for k in ("reward_mean", "crash_rate", "pg_loss",
                                                  "v_loss", "entropy", "env_steps_per_s")})

    save_path = args.save_path or os.path.join(tempfile.gettempdir(),
                                               f"{args.task}_cleanrl.ckpt")
    trainer.save_checkpoint(save_path)
    last = history[-1]
    print(f"done: reward {last['reward_mean']:.3f} "
          f"steps/s {last['env_steps_per_s']:.0f} wall {last['wall_s']:.1f}s")
    return history


if __name__ == "__main__":
    main()
