"""One rank of the 2-process CPU cluster behind tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py --process_id R --num_processes 2 \
        --coordinator 127.0.0.1:PORT --work DIR

Every cross-process check of the port's parallel layer runs here, on gloo,
at the scale of the JAX package's tests; rank 0 prints one line
``PARALLEL_SUMMARY {json}`` that the tests read, and writes the sharded
task step's outputs to DIR/task_step.npz for the comparison with the JAX
package (this process imports no JAX). Each part compares the sharded run
with the unsharded one computed here on the same seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import aerial_gym_simulator_tpu_torch as port  # noqa: E402
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (  # noqa: E402
    BaseDepthCameraConfig)
from aerial_gym_simulator_tpu_torch.models.vit import (  # noqa: E402
    TensorParallelViTEncoder, ViTEncoder)
from aerial_gym_simulator_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from aerial_gym_simulator_tpu_torch.parallel import multiproc  # noqa: E402
from aerial_gym_simulator_tpu_torch.parallel.distributed import (  # noqa: E402
    shard_bptt_trainer, shard_ppo_trainer, shard_trainer)
from aerial_gym_simulator_tpu_torch.rl import bptt as t_bptt  # noqa: E402
from aerial_gym_simulator_tpu_torch.rl import population as t_pop  # noqa: E402
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo  # noqa: E402
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer  # noqa: E402
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (  # noqa: E402
    build_ray_sensor_params)
from aerial_gym_simulator_tpu_torch.sim.convert import state_from_numpy  # noqa: E402
from aerial_gym_simulator_tpu_torch.sim.structs import replace  # noqa: E402
from aerial_gym_simulator_tpu_torch.tasks import position_setpoint_task as t_pos  # noqa: E402

POP_CFG = dict(num_envs=8, horizon=4, minibatch_size=32, epochs=2, seed=3)


def shard_of(n_global):
    return meshlib.env_sharding(meshlib.make_mesh(), n_global)


def gathered(x, shard):
    return meshlib.gather_env_pytree(x, shard)


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def leaf_diffs(a, b) -> dict:
    """{field: max |a - b|} over two records' tensor fields."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            out[f.name] = max_diff(x.float(), y.float())
    return out


def params_of(module):
    return [p.detach().clone() for p in module.parameters()]


def params_diff(a, b) -> float:
    return max(max_diff(x, y) for x, y in zip(a, b))


# -- the parts ---------------------------------------------------------------------


def task_step_part(work):
    """JAX test_parallel.py:20-49: the state carried across from the JAX
    package, one task_step on each rank's block; rank 0 saves the whole."""
    with open(os.path.join(work, "task_step_in.pkl"), "rb") as f:
        given = pickle.load(f)
    n = given["actions"].shape[0]
    task = port.task_registry.make_task("position_setpoint_task", num_envs=n, seed=5,
                                        device="cpu")
    sh = shard_of(n)
    state = state_from_numpy(given["state"], "cpu", seed=11)
    meshlib.shard_params_(task.params, sh)
    local = meshlib.shard_env_pytree(state, sh, n)
    meshlib.register_generators(local, sh)
    actions = torch.from_numpy(given["actions"])[sh.offset:sh.offset + sh.n_local]
    target = torch.zeros((sh.n_local, 3))
    out, obs, rew, crashes, trunc = t_pos.task_step(task.params, local, actions, target, 500,
                                                    8.0, None)
    whole = {k: gathered(v, sh).numpy() for k, v in
             dict(obs=obs, reward=rew, pos=out.pos, crashes=crashes, truncations=trunc).items()}
    if sh.rank == 0:
        np.savez(os.path.join(work, "task_step.npz"), **whole)
    return {"envs_per_rank": sh.n_local}


def _position_task(n, seed, episode_len=None):
    cfg = port.task_registry.get_task_config("position_setpoint_task")
    if episode_len is not None:
        cfg = dataclasses.replace(cfg, episode_len_steps=episode_len)
    return port.task_registry.make_task("position_setpoint_task", num_envs=n, seed=seed,
                                        task_config=cfg, device="cpu")


def rollout_part():
    """The draw rule: a 2-rank rollout under fixed seeded actions against
    the 1-rank one, row for row, over enough steps that envs reset."""
    n, steps = 16, 12
    actions = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (steps, n, 4)).astype(np.float32))

    def run(shard):
        task = _position_task(n, seed=3, episode_len=5)
        step_fn, carry, obs = task.make_step_fn()
        rows = slice(0, n)
        if shard is not None:
            meshlib.shard_task(task, shard)
            carry = meshlib.shard_env_pytree(carry, shard, n)
            meshlib.register_generators(carry, shard)
            rows = slice(shard.offset, shard.offset + shard.n_local)
        out = []
        for t in range(steps):
            carry, obs, rew, term, trunc = step_fn(carry, actions[t, rows])
            out.append((obs, rew, term, trunc))
        return carry, out

    ref_carry, ref = run(None)
    sh = shard_of(n)
    carry, got = run(sh)
    resets = int(sum(float((torch.maximum(r[2], r[3]) > 0).sum()) for r in ref))
    per_step = {"obs": 0.0, "reward": 0.0, "flags": 0.0}
    for (o, r, te, tr), (ro, rr, rte, rtr) in zip(got, ref):
        per_step["obs"] = max(per_step["obs"], max_diff(gathered(o, sh), ro))
        per_step["reward"] = max(per_step["reward"], max_diff(gathered(r, sh), rr))
        per_step["flags"] = max(per_step["flags"], max_diff(gathered(te, sh), rte),
                                max_diff(gathered(tr, sh), rtr))
    whole = gathered(carry, sh)
    return {"resets": resets, "steps": steps, "per_step": per_step,
            "state": leaf_diffs(whole, ref_carry),
            "rng_state_equal": bool(torch.equal(carry.rng.get_state(),
                                                ref_carry.rng.get_state()))}


def _small_nav_task(n, seed):
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              use_vae=False)
    task = port.task_registry.make_task("navigation_task", num_envs=n, seed=seed,
                                        task_config=cfg, device="cpu")
    task.params = replace(task.params, camera=build_ray_sensor_params(
        BaseDepthCameraConfig(height=27, width=48), "cpu"))
    return task


def nav_rollout_part():
    """The navigation task (render with noise-free depth, curriculum sums,
    resets) sharded against whole, under fixed actions."""
    n, steps = 4, 3
    actions = torch.from_numpy(np.random.default_rng(1).uniform(
        -1.0, 1.0, (steps, n, 4)).astype(np.float32))

    def run(shard):
        task = _small_nav_task(n, seed=2)
        step_fn, carry, _ = task.make_step_fn()
        rows = slice(0, n)
        if shard is not None:
            meshlib.shard_task(task, shard)
            carry = meshlib.shard_env_pytree(carry, shard, n)
            meshlib.register_generators(carry, shard)
            rows = slice(shard.offset, shard.offset + shard.n_local)
        obs_all = []
        for t in range(steps):
            carry, obs, *_ = step_fn(carry, actions[t, rows])
            obs_all.append(obs)
        return carry, obs_all

    ref_carry, ref_obs = run(None)
    sh = shard_of(n)
    carry, obs = run(sh)
    return {"obs": max(max_diff(gathered(o, sh), r) for o, r in zip(obs, ref_obs)),
            "sim": leaf_diffs(gathered(carry.sim, sh), ref_carry.sim),
            "curriculum_level_equal": bool(torch.equal(carry.curriculum_level,
                                                       ref_carry.curriculum_level))}


def update_part():
    """A 2-rank PPO update on a fixed rollout against the 1-rank update:
    one epoch, the minibatch the whole batch, then two minibatches, then two
    minibatches of whole GRU sequences."""
    n, horizon = 16, 4
    out = {}
    for case, mb, rnn in (("whole_batch", n * horizon, None),
                          ("two_minibatches", n * horizon // 2, None),
                          ("gru_two_minibatches", n * horizon // 2, "gru")):
        cfg = PPOConfig(num_envs=n, horizon=horizon, minibatch_size=mb, epochs=1, seed=4,
                        rnn=rnn, rnn_hidden=8)
        ref = PPOTrainer(_position_task(n, seed=4), cfg)
        ro = ref.collect_rollout()
        m_ref = ref.update(ro)
        tr = PPOTrainer(_position_task(n, seed=4), cfg)
        tr.collect_rollout()
        sh = shard_of(n)
        shard_ppo_trainer(tr, sh)
        cols = slice(sh.offset, sh.offset + sh.n_local)
        local = t_ppo.Rollout(**{                       # (T, N, ...) fields; h0 is (N, H)
            f.name: None if v is None else (v[cols] if f.name == "h0" else v[:, cols])
            for f in dataclasses.fields(t_ppo.Rollout) for v in [getattr(ro, f.name)]})
        m = tr.update(local)
        out[case] = {"params": params_diff(params_of(tr.network), params_of(ref.network)),
                     "metrics": max(abs(float(m[k]) - float(m_ref[k])) for k in m_ref),
                     "norm": max(max_diff(tr.norm[k], ref.norm[k]) for k in ref.norm),
                     "identical_across_ranks": multiproc.param_norms_equal(tr.network, sh)[0]}
    return out


def identical_part():
    """Parameters bit-identical across ranks after sharded navigation PPO
    (min-pooled depth, JAX test_parallel.py:79-98) and sharded BPTT."""
    nav = _small_nav_task(4, seed=2)
    tr = PPOTrainer(nav, PPOConfig(num_envs=4, horizon=2, minibatch_size=8, epochs=1, seed=2))
    shard_trainer(tr)
    hist = tr.train(total_env_steps=8, log_every=1)
    out = {"nav_ppo": multiproc.param_norms_equal(tr.network, tr.shard)[0],
           "nav_ppo_finite": bool(np.isfinite(hist[-1]["reward_mean"]))}
    bt = t_bptt.BPTTTrainer(_position_task(8, seed=4),
                            t_bptt.BPTTConfig(num_envs=8, horizon=4, iters=3, seed=4))
    shard_bptt_trainer(bt, None)
    bh = bt.train(log_every=1)
    ref = t_bptt.BPTTTrainer(_position_task(8, seed=4),
                             t_bptt.BPTTConfig(num_envs=8, horizon=4, iters=3, seed=4))
    rh = ref.train(log_every=1)
    out.update(bptt=multiproc.param_norms_equal(bt.policy, bt.shard)[0],
               bptt_vs_unsharded=params_diff(params_of(bt.policy), params_of(ref.policy)),
               bptt_reward_vs_unsharded=abs(bh[-1]["task_reward"] - rh[-1]["task_reward"]))
    return out


def _pop_factory(s):
    return _position_task(8, seed=s)


def population_part():
    """JAX test_population.py:132-177: the population dealt over the ranks
    (with PBT across them), each member's env batch over both ranks, and the
    indivisible case."""
    out = {}
    cfg = PPOConfig(**POP_CFG)
    steps = 2 * 8 * 4
    for case, kw in (("members", dict(env_devices=1)), ("env_devices_2", dict(env_devices=2))):
        lrs = [1e-4, 1e-3]
        pop = t_pop.PopulationTrainer(_pop_factory, cfg, num_seeds=2, member_lrs=lrs)
        ref = t_pop.PopulationTrainer(_pop_factory, cfg, num_seeds=2, member_lrs=lrs)
        pop.shard(**kw)
        hp = pop.train(total_env_steps=steps, log_every=1, pbt_every=1)
        hr = ref.train(total_env_steps=steps, log_every=1, pbt_every=1)
        diffs = [params_diff(params_of(pop.members[i].network), params_of(ref.members[i].network))
                 for i in pop.local]
        out[case] = {"local": pop.local, "params": max(diffs),
                     "rewards": float(np.abs(hp[-1]["reward_mean"] - hr[-1]["reward_mean"]).max()),
                     "lrs": max(abs(float(pop.members[i].lr) - float(ref.members[i].lr))
                                for i in pop.local)}
    bad = t_pop.PopulationTrainer(_pop_factory, cfg, num_seeds=3)
    try:
        bad.shard()
        out["indivisible_raises"] = False
    except ValueError as e:
        out["indivisible_raises"] = "multiple of" in str(e)
    return out


def tp_vit_part():
    """JAX test_vit.py:56-77: the tensor-parallel encoder (two heads per
    rank) against the unsharded one."""
    torch.manual_seed(0)
    enc = ViTEncoder(latent_dim=8, patch=(9, 16), dim=32, depth=2, num_heads=4,
                     attn_impl="fused", num_tokens=4).eval()
    x = torch.rand(4, 18, 32, 1)
    with torch.no_grad():
        mean, logvar = enc(x)
    rank, world = meshlib.global_rank(), meshlib._dist().get_world_size()
    tp = TensorParallelViTEncoder(enc, rank, world)
    t_mean, t_logvar = tp(x)
    q = tp.blocks[0].q_w
    return {"mean": max_diff(t_mean, mean), "logvar": max_diff(t_logvar, logvar),
            "q_rows_per_rank": int(q.shape[0]), "q_rows_whole": int(enc.blocks[0].attn.dim)}


def elastic_part(work):
    """JAX test_elastic.py:111-135: a 2-rank run saved, then restored into
    a 1-rank trainer exactly, which trains on."""
    n = 8
    cfg = PPOConfig(num_envs=n, horizon=4, minibatch_size=16, epochs=1, seed=5)
    ckpt = os.path.join(work, "elastic")
    t2 = PPOTrainer(_position_task(n, seed=5), cfg)
    shard_trainer(t2)
    t2.train(total_env_steps=2 * n * 4, ckpt_dir=ckpt, save_every=2)
    saved = params_of(t2.network)
    pos = gathered(t2.env_carry.pos, t2.shard)
    out = {}
    if meshlib.is_root():
        t1 = PPOTrainer(_position_task(n, seed=5), cfg)
        start = t1.restore_training_state(ckpt)
        out = {"start": start, "params": params_diff(params_of(t1.network), saved),
               "pos_equal": bool(torch.equal(t1.env_carry.pos, pos))}
        hist = t1.train(total_env_steps=3 * n * 4, ckpt_dir=ckpt, save_every=0)
        out["finite"] = bool(np.isfinite(hist[-1]["reward_mean"]))
    meshlib.barrier(t2.shard, torch.device("cpu"))
    return out


def cli_part(work):
    """The three command lines with their multi-device flags in this world."""
    sh = shard_of(8)
    hist = t_ppo.main(["--cpu", "--multichip", "--num_envs", "8", "--horizon", "4",
                       "--total_steps", "64"])
    rewards = torch.zeros(sh.world)
    rewards[sh.rank] = hist[-1]["reward_mean"]
    meshlib.all_reduce_(rewards, sh)
    trainer = t_bptt.main(["--cpu", "--multihost", "--num_envs", "8", "--horizon", "3",
                           "--iters", "2"])
    best = os.path.join(work, "best.ckpt")
    pop = t_pop.main(["--cpu", "--multichip", "--num_envs", "8", "--num_seeds", "2",
                      "--horizon", "4", "--total_steps", "64", "--save_best", best])
    meshlib.barrier(sh, torch.device("cpu"))     # the owner of the best member has written
    return {"ppo_same_history": bool(rewards[0] == rewards[1]),
            "ppo_envs_per_rank": 4,
            "bptt_sharded": trainer.shard is not None,
            "bptt_identical": multiproc.param_norms_equal(trainer.policy, trainer.shard)[0],
            "population_local": pop.local,
            "best_saved": os.path.exists(best)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--work", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    summary = {"multiproc": multiproc.run_worker(
        args.process_id, args.num_processes, args.coordinator, "cpu",
        os.path.join(args.work, "mp_ckpt"))}
    summary["task_step"] = task_step_part(args.work)
    summary["rollout"] = rollout_part()
    summary["nav_rollout"] = nav_rollout_part()
    summary["update"] = update_part()
    summary["identical"] = identical_part()
    summary["population"] = population_part()
    summary["tp_vit"] = tp_vit_part()
    summary["elastic"] = elastic_part(args.work)
    summary["cli"] = cli_part(args.work)
    if args.process_id == 0:
        print("PARALLEL_SUMMARY " + json.dumps(summary), flush=True)
    print(f"PARALLEL_WORKER_OK {args.process_id}", flush=True)


if __name__ == "__main__":
    main()
