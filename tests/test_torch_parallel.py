"""Port parity for the parallel layer: the sharded port against the JAX
package and against the unsharded port, on a 2-process gloo cluster on the
CPU.

One module-scoped cluster (``tests/torch_parallel_worker.py``, two ranks of
a few envs, the scale of the JAX package's tests) runs every cross-process
check and returns a JSON summary; the tests below assert on its parts. The
two scaling rehearsals spawn their own 1- and 2-process legs, started in the
background while the cluster runs.

Tolerances:
  * the sharded task step against JAX's unsharded ``task_step`` on the state
    carried across by ``sim/convert.py``: 1e-5 (JAX test_parallel.py:20-49),
    with no env reset in the step;
  * the draw rule: a 2-rank rollout of the position task (and of the
    navigation task, render and curriculum included) against the 1-rank one,
    row for row, resets included: bit-equal. The two small products whose
    GEMM rounding follows the row count on CUDA run row by row
    (``utils/math.rowwise_matmul``), and the CPU's products round alike at
    every row count, so no field of the state needs the 1e-6 allowed for a
    batched matrix product (the card's check of the same is in
    tests/test_torch_kernels.py and chip_smoke.py phase 16);
  * a 2-rank PPO update on a fixed rollout against the 1-rank one (MLP, and
    GRU over whole env sequences): 1e-5 on parameters, normalizer and
    metrics (the global minibatch's sums run in another order);
  * parameters bit-identical across ranks after sharded PPO, navigation PPO,
    LiDAR-navigation PPO and BPTT (JAX's atol 0); sharded BPTT against
    unsharded within 1e-5;
  * the population dealt over the ranks and with each member's envs over
    both ranks, PBT across ranks included: within 1e-5 of the unsharded one
    (JAX test_population.py:132-169);
  * the tensor-parallel ViT against the unsharded encoder: 2e-5 (JAX
    test_vit.py:74);
  * elastic rejoin 2 -> 1: parameters and state exact (JAX
    test_elastic.py:111-135).
"""

import concurrent.futures
import inspect
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.parallel import scaling as j_scaling
from aerial_gym_simulator_tpu.tasks.position_setpoint_task import task_step as j_task_step

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.parallel import mesh as meshlib
from aerial_gym_simulator_tpu_torch.parallel import dryrun, multiproc, scaling
from aerial_gym_simulator_tpu_torch.parallel.distributed import (
    default_backend, initialize_multihost, shard_trainer)
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy
from aerial_gym_simulator_tpu_torch.utils import env_rng

WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
TASK_STEP_ENVS = 64
ACTION = np.array([0.1, -0.2, 0.3, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Thousands of tiny eager ops: one intra-op thread while this module
    runs (the workers pin theirs too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rehearsals():
    """The weak and the strong rehearsal, each in its own thread, started
    before the cluster so that their processes overlap it."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {
        "weak": pool.submit(scaling.run_rehearsal, num_processes=2, envs_per_device=8,
                            horizon=4, warmup_iters=1, timed_iters=2, verbose=False,
                            device="cpu"),
        "strong": pool.submit(scaling.run_strong_rehearsal, num_processes=2, total_envs=32,
                              horizon=4, warmup_iters=1, timed_iters=2, verbose=False,
                              device="cpu"),
    }
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_task_step():
    """JAX's unsharded task step on 64 envs, seed 5 (test_parallel.py:20-49),
    and its input state as the port reads it."""
    task = ag.task_registry.make_task("position_setpoint_task", num_envs=TASK_STEP_ENVS,
                                      seed=5)
    task.reset()
    actions = np.tile(ACTION, (TASK_STEP_ENVS, 1))
    target = jnp.zeros((TASK_STEP_ENVS, 3), jnp.float32)
    state, obs, rew, crashes, trunc = jax.jit(
        lambda s, a: j_task_step(task.params, s, a, target, 500, 8.0, None))(
        task.state, jnp.asarray(actions))
    return {"input": {"state": record_to_numpy(task.state), "actions": actions},
            "obs": np.asarray(obs), "reward": np.asarray(rew), "pos": np.asarray(state.pos),
            "crashes": np.asarray(crashes), "truncations": np.asarray(trunc)}


@pytest.fixture(scope="module")
def cluster(rehearsals, jax_task_step, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    with open(os.path.join(work, "task_step_in.pkl"), "wb") as f:
        pickle.dump(jax_task_step["input"], f)
    port_ = multiproc.free_port()
    argvs = [[sys.executable, WORKER, "--process_id", str(r), "--num_processes", "2",
              "--coordinator", f"127.0.0.1:{port_}", "--work", work] for r in range(2)]
    rcs, outputs = multiproc.spawn(argvs, 600.0, env=multiproc.worker_env())
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n" + "\n".join(out.splitlines()[-40:])
                          for r, (rc, out) in enumerate(zip(rcs, outputs)))
        pytest.fail(f"the parallel cluster failed:\n{tails}")
    line = next(x for x in outputs[0].splitlines() if x.startswith("PARALLEL_SUMMARY "))
    summary = json.loads(line[len("PARALLEL_SUMMARY "):])
    summary["task_step_out"] = dict(np.load(os.path.join(work, "task_step.npz")))
    return summary


# -- JAX's multi-process contract -------------------------------------------------


def test_multiprocess_cluster_end_to_end(cluster):
    """JAX test_parallel.py:135-157: the rendezvous, a global sum, sharded
    PPO with the learner bit-identical across ranks, the checkpoint
    roundtrip, LiDAR-navigation PPO with the whole sensor pipeline."""
    mp = cluster["multiproc"]
    assert mp["backend"] == "gloo"
    assert mp["param_norm"] > 0 and mp["lidar_param_norm"] > 0


def test_sharded_task_step_matches_jax(cluster, jax_task_step):
    out = cluster["task_step_out"]
    assert cluster["task_step"]["envs_per_rank"] == TASK_STEP_ENVS // 2
    # no env reset in the step, in either package: the draws cannot hide here
    for key in ("crashes", "truncations"):
        assert not jax_task_step[key].any() and not out[key].any(), key
    for key in ("obs", "reward", "pos"):
        np.testing.assert_allclose(out[key], jax_task_step[key], atol=1e-5, err_msg=key)


# -- the draw rule ----------------------------------------------------------------------


def test_sharded_rollout_is_the_unsharded_one_row_for_row(cluster):
    r = cluster["rollout"]
    assert r["resets"] > 0, "no env reset in the rollout: the reset draws went untested"
    assert r["per_step"] == {"obs": 0.0, "reward": 0.0, "flags": 0.0}
    assert all(v == 0.0 for v in r["state"].values()), r["state"]
    assert r["rng_state_equal"]


def test_sharded_navigation_rollout_is_the_unsharded_one(cluster):
    r = cluster["nav_rollout"]
    assert r["obs"] == 0.0
    assert all(v == 0.0 for v in r["sim"].values()), r["sim"]
    assert r["curriculum_level_equal"]


def test_env_rand_keeps_this_ranks_rows():
    shard = meshlib.EnvShard(rank=1, world=2, offset=4, n_local=4, n_global=8)
    g, ref = torch.Generator(), torch.Generator()
    g.manual_seed(7)
    ref.manual_seed(7)
    env_rng.set_shard(g, shard)
    assert torch.equal(env_rng.env_rand(g, (4, 3)), torch.rand((8, 3), generator=ref)[4:])
    assert torch.equal(env_rng.env_randn(g, (2, 4, 3), dim=1),
                       torch.randn((2, 8, 3), generator=ref)[:, 4:])
    assert torch.equal(g.get_state(), ref.get_state())           # lockstep
    with pytest.raises(ValueError, match="sharded to 4 of 8"):
        env_rng.env_rand(g, (8, 3))
    env_rng.set_shard(g, None)
    assert env_rng.shard_of(g) is None


def _trained(register_world_of_one: bool):
    task = port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=2,
                                        device="cpu")
    tr = PPOTrainer(task, PPOConfig(num_envs=8, horizon=4, minibatch_size=16, epochs=2,
                                    seed=2))
    if register_world_of_one:
        assert shard_trainer(tr).size == 1 and tr.shard is None
        one = meshlib.EnvShard(0, 1, 0, 8, 8)
        meshlib.register_generators(tr.env_carry, one)
        env_rng.set_shard(tr.generator, one)
    hist = tr.train(total_env_steps=8 * 4 * 2, log_every=1)
    return hist, [p.detach().clone() for p in tr.network.parameters()]


def test_world_of_one_is_the_unsharded_trainer():
    """No process group: shard_trainer leaves the trainer as it is, and the
    draw rule at a world of one (every draw made at N and narrowed to all
    N rows) gives today's numbers bit for bit."""
    assert not meshlib.world_initialized()
    h0, p0 = _trained(False)
    h1, p1 = _trained(True)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert [m["reward_mean"] for m in h0] == [m["reward_mean"] for m in h1]


# -- the update and the learner --------------------------------------------------


@pytest.mark.parametrize("case", ["whole_batch", "two_minibatches", "gru_two_minibatches"])
def test_sharded_update_matches_one_rank(cluster, case):
    u = cluster["update"][case]
    assert u["identical_across_ranks"]
    assert u["params"] <= 1e-5 and u["norm"] <= 1e-5 and u["metrics"] <= 1e-5, u


@pytest.mark.parametrize("trainer", ["nav_ppo", "bptt"])
def test_parameters_identical_across_ranks(cluster, trainer):
    ident = cluster["identical"]
    assert ident[trainer]
    if trainer == "nav_ppo":
        assert ident["nav_ppo_finite"]
    else:
        assert ident["bptt_vs_unsharded"] <= 1e-5
        assert ident["bptt_reward_vs_unsharded"] <= 1e-5


# -- the population, the tensor-parallel ViT, elastic rejoin ------------------------


@pytest.mark.parametrize("case", ["members", "env_devices_2"])
def test_sharded_population_matches_unsharded(cluster, case):
    p = cluster["population"][case]
    assert p["local"] == ([0, 1] if case == "env_devices_2" else [0])
    assert p["params"] <= 1e-5 and p["rewards"] <= 1e-5 and p["lrs"] <= 1e-9, p


def test_population_shard_rejects_indivisible(cluster):
    assert cluster["population"]["indivisible_raises"]


def test_vit_tensor_parallel_matches_unsharded(cluster):
    t = cluster["tp_vit"]
    assert t["q_rows_per_rank"] * 2 == t["q_rows_whole"]       # the map really shards
    assert t["mean"] <= 2e-5 and t["logvar"] <= 2e-5, t


def test_elastic_rejoin_on_fewer_ranks(cluster):
    e = cluster["elastic"]
    assert e["start"] == 2 and e["params"] == 0.0 and e["pos_equal"] and e["finite"]


def test_command_lines_shard_over_the_world(cluster):
    c = cluster["cli"]
    assert c["ppo_same_history"] and c["bptt_sharded"] and c["bptt_identical"]
    assert c["population_local"] == [0] and c["best_saved"]


# -- the harnesses -------------------------------------------------------------------


def test_dry_topology_matches_jax():
    """Every numeric field equal to the JAX package's
    (test_parallel.py:199-214), and its ValueError."""
    for args in ((4, 4, 16384), (2, 4, 8192), (1, 1, 64)):
        got, want = scaling.dry_topology(*args), j_scaling.dry_topology(*args)
        for key in ("num_hosts", "chips_per_host", "mesh_shape", "num_envs", "envs_per_device",
                    "mesh_axes"):
            assert got[key] == want[key], key
    topo = scaling.dry_topology(num_hosts=4, chips_per_host=4, num_envs=16384)
    assert "all_reduce" in topo["collectives"]["gradient"]
    assert "replicated" in topo["shardings"]["learner_params/opt_state"]
    with pytest.raises(ValueError):
        scaling.dry_topology(num_hosts=3, chips_per_host=4, num_envs=1000)


def test_scaling_efficiency_rehearsal_runs(rehearsals, cluster):
    s = rehearsals["weak"].result()
    assert s["single_process"]["steps_per_s"] > 0 and s["multi_process"]["steps_per_s"] > 0
    assert s["multi_process"]["global_devices"] == 2
    assert 0 < s["efficiency"]


def test_strong_scaling_rehearsal_same_workload(rehearsals, cluster):
    s = rehearsals["strong"].result()
    assert s["single_process"]["num_envs"] == s["multi_process"]["num_envs"] == 32
    assert s["single_process"]["steps_per_s"] > 0 and s["multi_process"]["steps_per_s"] > 0
    # loose on purpose: gloo over loopback on shared cores may lose to one process
    assert 0.02 < s["throughput_ratio"] < 50


@pytest.mark.parametrize("fn", [multiproc.launch_cluster, dryrun.run_dryrun,
                                scaling.run_rehearsal, scaling.run_strong_rehearsal,
                                scaling.timed_train_steps_per_s])
def test_harnesses_run_on_cuda_unless_asked_for_the_cpu(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_harness_workers_get_the_cpu_flag_only_for_the_cpu(monkeypatch, device):
    """Each launcher hands its device to its workers as the command line's
    ``--cpu`` (absent: CUDA); ``spawn`` is stubbed, so nothing starts."""
    seen = []

    def fake_spawn(argvs, timeout_s, env=None):
        seen.extend(list(a) for a in argvs)
        outs = [f"MULTIPROC_WORKER_OK {i}/2 backend=gloo\nMULTIPROC_LIDAR_OK {i}/2\n"
                f"DRYRUN_RANK_OK {i}/2\nSCALING_RESULT "
                + json.dumps({"num_processes": 2, "global_devices": 2, "num_envs": 8,
                              "steps_per_s": 1.0})
                for i in range(len(argvs))]
        return [0] * len(argvs), outs

    monkeypatch.setattr(multiproc, "spawn", fake_spawn)
    multiproc.launch_cluster(2, device=device, verbose=False)
    dryrun.run_dryrun(2, device=device)
    scaling._spawn_leg(2, "position_setpoint_task", 4, 4, 1, 1, 60.0, device)
    assert len(seen) == 6
    assert all(("--cpu" in argv) == (device == "cpu") for argv in seen)
    assert not any("--device" in argv for argv in seen)


def test_barrier_waits_on_the_host(monkeypatch):
    """NCCL returns from ``all_reduce`` once the collective is enqueued, so
    the barrier must read its token back before the rank goes on (a
    checkpoint written by the root before the barrier was missing on the
    other ranks of a four-GPU NCCL run without the read)."""
    events = []

    class EnqueueOnly:
        @staticmethod
        def all_reduce(t, group=None):
            events.append(("enqueued", t.data_ptr()))

    real_item = torch.Tensor.item

    def item(t):
        events.append(("read", t.data_ptr()))
        return real_item(t)

    monkeypatch.setattr(meshlib, "_dist", lambda: EnqueueOnly)
    monkeypatch.setattr(torch.Tensor, "item", item)
    meshlib.barrier(meshlib.EnvShard(0, 2, 0, 4, 8), torch.device("cpu"))
    assert [e[0] for e in events] == ["enqueued", "read"] and events[0][1] == events[1][1]


def test_backend_is_chosen_by_rule(monkeypatch):
    assert default_backend("cuda", 1) == "nccl"
    assert default_backend("cuda", 2) == "gloo"
    assert default_backend("cpu", 1) == "gloo"
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False                  # no coordinator: one process
    with pytest.raises(RuntimeError, match="no coordinator"):
        initialize_multihost(require=True)
