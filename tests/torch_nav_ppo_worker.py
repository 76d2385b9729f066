"""One rank of the 2-process CPU cluster behind
tests/test_torch_nav_ppo_recipe.py's sharded update.

    python tests/torch_nav_ppo_worker.py --rank R --world 2 \
        --coordinator 127.0.0.1:PORT --case CASE --out DIR

Builds the recipe's recurrent trainer (``ppo_config_from_yaml`` of the
shipped navigation YAML at ``world=2``, cut to the case's size) on this
rank's block of a stub task, trains one iteration so that Adam has a
history, then collects a rollout and runs one update. Each rank writes
DIR/rank<R>.pt: its rollout, the hidden state and observation after it,
the learner before the update (parameters, Adam, lr, normalizer, the
generator's state) and the parameters after it. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nav_ppo_stub import CASES, StubTask, recipe_config, snapshot  # noqa: E402

from aerial_gym_simulator_tpu_torch.parallel.distributed import (  # noqa: E402
    env_block, initialize_multihost)
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOTrainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--case", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    initialize_multihost(args.coordinator, args.world, args.rank, require=True, backend="gloo")
    case = CASES[args.case]
    cfg = recipe_config(case, world=args.world)
    trainer = PPOTrainer(StubTask(cfg.num_envs, shard=env_block(cfg.num_envs)), cfg)
    trainer.train_iteration()
    ro = trainer.collect_rollout()
    before = snapshot(trainer)
    trainer.update(ro)
    torch.save(dict(before, rollout=vars(ro), after=dict(trainer.network.state_dict())),
               os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"NAV_PPO_WORKER_OK {args.rank}", flush=True)


if __name__ == "__main__":
    main()
