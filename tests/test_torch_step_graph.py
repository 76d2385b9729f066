"""The physics step replayed from CUDA graphs (sim/step_graph.py).

On the CPU: the capture rule (eager on the CPU and wherever an input needs
a gradient), what the cache key follows (the substep count, the ``params``
leaves, the generator's shard, the shapes), the engagement counter, the
packing of the state into flat buffers, and that ``env_step`` on the CPU is
the eager step. This file imports only the port, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_step_graph.py -q -m cuda    # on the card

Tests marked ``cuda`` step the same state through the graph and through
``env_step_eager`` and require the same bits: every state field and the
generator's state after each step, resets drawing from the generator
between steps; the graph replays the eager step's kernels in its order on
the same inputs, so nothing else is expected.
"""

import dataclasses

import pytest
import torch

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.parallel import mesh as meshlib
from aerial_gym_simulator_tpu_torch.sim import dynamics, step_graph
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.utils import env_rng


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many eager ops on small tensors: one intra-op thread while this
    module runs (several test workers share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run this file with -m cuda on the H100")
    return torch.device("cuda")


BUILDS = {
    "obstacle_camera": ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
                        "lee_velocity_control"),
    "lmf2_navigation": ("base_sim", "env_with_obstacles", "lmf2", "lmf2_velocity_control"),
    "articulated": ("base_sim", "empty_env", "snakey", "no_control"),
    "quad": ("base_sim", "empty_env", "base_quadrotor", "lee_velocity_control"),
}


def build(name, device, num_envs, seed=3, shard=None):
    return port.SimBuilder().build_env(*BUILDS[name], device=str(device), num_envs=num_envs,
                                       seed=seed, shard=shard)


def actions(env, gen, scale=1.0):
    n, m = env.num_envs, env.num_robot_actions
    return (torch.rand((n, m), generator=gen, device=env.device) * 2.0 - 1.0) * scale


def copy_state(state):
    """The state with its own tensors and its own generator in the same
    state (and shard)."""
    gen = torch.Generator(device=state.device)
    gen.set_state(state.rng.get_state())
    env_rng.set_shard(gen, env_rng.shard_of(state.rng))
    return replace(state, rng=gen, **{k: getattr(state, k).clone()
                                      for k in step_graph.STATE_TENSORS})


def assert_same_state(a, b, what="", rng=True):
    for k in step_graph.STATE_TENSORS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, k)
        assert torch.equal(x, y), (what, k)
    if rng:
        assert torch.equal(a.rng.get_state(), b.rng.get_state()), (what, "rng")


def counts():
    return dict(dynamics.STEP_GRAPHS)


def delta(before):
    return {k: v - before[k] for k, v in dynamics.STEP_GRAPHS.items()}


# ---------------------------------------------------------------------------
# CPU: the rule, the key, the counter, the packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["obstacle_camera", "lmf2_navigation"])
def test_the_rule_picks_eager_on_the_cpu(name):
    env = build(name, "cpu", 4)
    a = torch.zeros((4, env.num_robot_actions))
    assert not step_graph.capturable(env.params, env.state, a)
    before = counts()
    env.step(a)
    assert delta(before) == {"captured": 0, "replayed": 0, "eager": 1}


def _requiring_grad(env, which):
    """(params, state, action) with ``which`` input requiring a gradient."""
    params, state = env.params, env.state
    a = torch.zeros((env.num_envs, env.num_robot_actions))
    if which == "action":
        a.requires_grad_(True)
    elif which == "state":
        state = replace(state, linvel=state.linvel.clone().requires_grad_(True))
    elif which == "params":
        rp = params.robot
        params = dataclasses.replace(params, robot=dataclasses.replace(
            rp, drag_lin_linear=rp.drag_lin_linear.clone().requires_grad_(True)))
    return params, state, a


@pytest.mark.parametrize("which", ["none", "action", "state", "params"])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_an_input_needing_a_gradient_means_eager(which, grad_mode):
    env = build("quad", "cpu", 4)
    params, state, a = _requiring_grad(env, which)
    with torch.set_grad_enabled(grad_mode):
        assert step_graph.needs_grad(params, state, a) == (grad_mode and which != "none")


@pytest.mark.parametrize("change", ["substeps", "params_rebuilt", "params_field", "shard",
                                    "action_shape", "generator"])
def test_the_key_follows_what_the_graph_bakes_in(change):
    env = build("obstacle_camera", "cpu", 4)
    params, state = env.params, env.state
    a = torch.zeros((4, env.num_robot_actions))
    key = step_graph.graph_key(params, state, a, 10)
    assert step_graph.graph_key(params, state, a.clone(), 10) == key
    # a record that holds the same leaves steps the same
    assert step_graph.graph_key(dataclasses.replace(params), state, a, 10) == key
    n = 10
    if change == "substeps":
        n = 7
    elif change == "params_rebuilt":
        params = build("obstacle_camera", "cpu", 4).params
    elif change == "params_field":
        params = dataclasses.replace(params, robot=dataclasses.replace(params.robot,
                                                                       mass=params.robot.mass * 2))
    elif change == "shard":
        gen = torch.Generator()
        gen.set_state(state.rng.get_state())
        env_rng.set_shard(gen, meshlib.EnvShard(1, 2, 4, 4, 8))
        state = replace(state, rng=gen)
        same_gen = step_graph.graph_key(params, state, a, 10)
        env_rng.set_shard(gen, meshlib.EnvShard(0, 2, 0, 4, 8))
        assert step_graph.graph_key(params, state, a, 10) != same_gen
    elif change == "action_shape":
        a = torch.zeros((4, env.num_robot_actions + 1))
    elif change == "generator":
        state = replace(state, rng=torch.Generator())
    assert step_graph.graph_key(params, state, a, n) != key


def test_the_counter_counts_eager_calls():
    env = build("quad", "cpu", 4)
    a = torch.zeros((4, env.num_robot_actions))
    before = counts()
    state = env.state
    for n in (1, 2, 3):
        state = dynamics.env_step(env.params, state, a, n)
    assert delta(before) == {"captured": 0, "replayed": 0, "eager": 3}


def test_profile_task_reports_the_counter(tmp_path, capsys):
    from aerial_gym_simulator_tpu_torch.utils.profiling import profile_task

    task = port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=0,
                                        device="cpu")
    report = profile_task(task, iters=2, trace_dir=str(tmp_path))
    # the warm-up call and two timed and two traced calls, all eager on the CPU
    assert report["step_graphs"] == {"captured": 0, "replayed": 0, "eager": 5}
    assert "physics steps (dynamics.STEP_GRAPHS): captured 0, replayed 0, eager 5" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("name", ["obstacle_camera", "lmf2_navigation", "articulated"])
def test_env_step_on_the_cpu_is_the_eager_step(name):
    env = build(name, "cpu", 4)
    gen = torch.Generator().manual_seed(1)
    s1, s2 = env.state, copy_state(env.state)
    for _ in range(3):
        a = actions(env, gen)
        s1 = dynamics.env_step(env.params, s1, a)
        s2 = dynamics.env_step_eager(env.params, s2, a)
        assert_same_state(s1, s2)


PACK_CASES = {
    "contiguous": lambda: [torch.arange(6.0).reshape(2, 3), torch.ones(4)],
    "expanded": lambda: [torch.tensor([1.0, 2.0, 3.0]).expand(5, 3), torch.zeros(2, 2)],
    "zero_size": lambda: [torch.zeros(3, 0), torch.arange(3.0)],
    "mixed_dtypes": lambda: [torch.arange(4, dtype=torch.int32), torch.rand(2, 2),
                             torch.arange(3, dtype=torch.int32).reshape(3, 1)],
    "sliced": lambda: [torch.arange(12.0).reshape(3, 4)[:, 1:3], torch.rand(1)],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_packing_round_trips_into_one_buffer_per_dtype(case):
    tensors = PACK_CASES[case]()
    pack = step_graph._Packing([(t.shape, t.dtype) for t in tensors])
    flats = pack.empty("cpu")
    assert len(flats) == len({t.dtype for t in tensors})
    pack.pack(tensors, flats)
    views = pack.views(flats)
    for t, v in zip(tensors, views):
        assert v.shape == t.shape and v.dtype == t.dtype and torch.equal(v, t)
    # the views are the buffers' memory, the packing a fresh buffer
    flats[0].fill_(0)
    owned = pack.views(pack.pack(tensors))
    for t, v in zip(tensors, owned):
        assert torch.equal(v, t)


# ---------------------------------------------------------------------------
# CUDA: the graph against the eager step
# ---------------------------------------------------------------------------


def _reset_mask(n, k, device):
    """Every seventh env from a step-dependent offset: resets draw from the
    generator between steps."""
    return ((torch.arange(n, device=device) + k) % 7 == 0).to(torch.float32)


def run_both(env, steps=20, reset_every=4, scale=1.0):
    """Steps ``env``'s state through ``env_step`` and a copy through
    ``env_step_eager`` with the same actions and resets; checks the bits
    after every step and that the state of step k is untouched by step k+1.
    -> the counter's delta."""
    params, dev, n = env.params, env.device, env.num_envs
    gen = torch.Generator(device=dev).manual_seed(11)
    sg, se = env.state, copy_state(env.state)
    before = counts()
    prev = kept = None
    for k in range(steps):
        a = actions(env, gen, scale)
        sg = dynamics.env_step(params, sg, a)
        se = dynamics.env_step_eager(params, se, a)
        assert_same_state(sg, se, f"step {k}")
        if prev is not None:
            # the generator is shared and moves on; the tensors must not
            assert_same_state(prev, kept, f"step {k - 1} after step {k}", rng=False)
        prev, kept = sg, copy_state(sg)
        if k % reset_every == reset_every - 1:
            mask = _reset_mask(n, k, dev)
            sg = dynamics.reset_envs(params, sg, mask)
            se = dynamics.reset_envs(params, se, mask)
            assert_same_state(sg, se, f"reset after step {k}")
    torch.cuda.synchronize()
    return delta(before)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["obstacle_camera", "lmf2_navigation", "articulated"])
def test_the_graph_is_the_eager_step_bit_for_bit(cuda_device, name):
    env = build(name, cuda_device, 256)
    assert step_graph.capturable(env.params, env.state,
                                 torch.zeros((256, env.num_robot_actions), device=cuda_device))
    d = run_both(env, scale=0.5 if name != "articulated" else 1.0)
    # seen once (eager), captured, then every call replayed
    assert d == {"captured": 1, "replayed": 18, "eager": 1}, d


@pytest.mark.cuda
def test_two_ranks_blocks_replay_their_own_graphs(cuda_device):
    """2 ranks' blocks of a 256-env obstacle env in one process, each built
    at its block with its generator told of the shard."""
    envs = [build("lmf2_navigation", cuda_device, 256,
                  shard=meshlib.EnvShard(r, 2, 128 * r, 128, 256)) for r in (0, 1)]
    keys = {step_graph.graph_key(e.params, e.state,
                                 torch.zeros((128, e.num_robot_actions), device=cuda_device),
                                 e.params.env.substep_mean) for e in envs}
    assert len(keys) == 2
    for e in envs:
        assert env_rng.shard_of(e.state.rng) is not None
        d = run_both(e, steps=12)
        assert d == {"captured": 1, "replayed": 10, "eager": 1}, d


@pytest.mark.cuda
def test_each_substep_count_has_its_own_graph(cuda_device):
    env = build("obstacle_camera", cuda_device, 256)
    params = env.params
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sg, se = env.state, copy_state(env.state)
    before, graphs = counts(), len(step_graph.GRAPHS.graphs)
    plan = (10, 10, 7, 7, 10, 7, 3, 3, 3)
    for n in plan:
        a = actions(env, gen, 0.5)
        sg = dynamics.env_step(params, sg, a, n)
        se = dynamics.env_step_eager(params, se, a, n)
        assert_same_state(sg, se, f"{n} substeps")
    # each count: eager when first seen, captured when seen again, then replayed
    assert delta(before) == {"captured": 3, "replayed": 3, "eager": 3}
    assert len(step_graph.GRAPHS.graphs) == min(graphs + 3, step_graph.MAX_GRAPHS)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["action", "state", "params"])
def test_a_call_needing_a_gradient_stays_eager_with_todays_gradient(cuda_device, which):
    env = build("quad", cuda_device, 256)
    params, state, _ = _requiring_grad(env, "none")
    leaf = {"action": torch.full((256, 4), 0.1, device=cuda_device),
            "state": state.linvel.clone(),
            "params": params.robot.drag_lin_linear.clone()}[which]

    def loss(step_fn):
        x = leaf.detach().clone().requires_grad_(True)
        p, st, a = params, copy_state(state), torch.full((256, 4), 0.1, device=cuda_device)
        if which == "action":
            a = x
        elif which == "state":
            st = replace(st, linvel=x)
        else:
            p = dataclasses.replace(params, robot=dataclasses.replace(params.robot,
                                                                      drag_lin_linear=x))
        for _ in range(3):
            st = step_fn(p, st, a)
        (st.pos.square().sum() + st.linvel.sum()).backward()
        return x.grad

    before = counts()
    g_graph_path = loss(dynamics.env_step)
    assert delta(before) == {"captured": 0, "replayed": 0, "eager": 3}
    g_eager = loss(dynamics.env_step_eager)
    assert torch.isfinite(g_eager).all() and g_eager.abs().sum() > 0
    assert torch.equal(g_graph_path, g_eager)


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_stays_eager(cuda_device):
    """A step reading a device value on the host breaks its capture: the key
    is remembered and runs eagerly, with the eager results."""
    tally = {"captured": 0, "replayed": 0, "eager": 0}
    graphs = step_graph.StepGraphs(counts=tally)
    env = build("quad", cuda_device, 64)

    def host_read_step(params, state, action, n):
        scale = float(action.abs().max()) + 1.0         # a host read
        return replace(state, pos=state.pos + scale * action[:, :3])

    state, a = env.state, torch.full((64, 4), 0.25, device=cuda_device)
    for _ in range(4):
        want = host_read_step(env.params, state, a, 1)
        state = graphs.step(host_read_step, env.params, state, a, 1)
        assert torch.equal(state.pos, want.pos)
    assert tally == {"captured": 0, "replayed": 0, "eager": 4}
    assert [g.graph for g in graphs.graphs.values()] == [None]
