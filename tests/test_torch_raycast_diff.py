"""Port parity for the differentiable ray cast (ops/raycast_diff.py) against
the JAX package's ``raycast_depth_diff`` in its "oracle" mode, on the scene
of tests/test_raycast_diff.py (env_with_obstacles, 2 envs, seed 7, the 8x128
ray table) with the JAX state carried across; and the oracle's finite
gradient on rays that miss (ROADMAP §C, C6).

Tolerances: the oracle's forward against JAX's at the depth bar
tests/test_torch_raycast.py holds the oracle to (2e-3); "kernel" (its plain
version on the CPU) within 1e-4 of "oracle", as JAX holds Pallas to its
oracle; every pose gradient within 1e-3 of the largest gradient magnitude
against jax.grad; the central finite difference at JAX's rtol 0.05 / atol
1e-2. Inverse rendering takes JAX's recipe (Adam 0.02 from a seeded 0.15 m
perturbation) for 60 steps with the loss below 1% of its start (it reads
0.04% there; JAX asks 5% after 150 steps): the eager oracle costs 0.3 s a
step on one CPU thread, and chip_smoke.py runs the recipe on the card.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.ops.raycast_diff import raycast_depth_diff as j_diff
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.ops import raycast as t_oracle
from aerial_gym_simulator_tpu_torch.ops.raycast_diff import raycast_depth_diff
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.utils.math import quat_rotate

DEPTH_ATOL = 2e-3
MAX_RANGE = 10.0


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many small eager ops: one intra-op thread while this module runs, so
    that the suite's workers do not contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ray_table(H=8, W=128):
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, H), np.linspace(-0.6, 0.6, W), indexing="ij")
    dirs = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    env = JSimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                  "lee_velocity_control", num_envs=2, seed=7)
    env.reset()
    tp = params_from_numpy(record_to_numpy(env.params), "cpu")
    ts = state_from_numpy(record_to_numpy(env.state), "cpu")
    dirs = _ray_table()
    return SimpleNamespace(jp=env.params, js=env.state, sc=tp.scene, ts=ts, dirs=dirs,
                           t_dirs=torch.from_numpy(dirs),
                           w=np.sin(np.arange(dirs.shape[0]) * 0.37).astype(np.float32))


def _poses(ts):
    return [x.clone().requires_grad_(True)
            for x in (ts.obstacle_pos, ts.obstacle_quat, ts.pos, ts.quat)]


def _weighted_hits(t, w):
    hit = t < t_oracle.NO_HIT_RAY_VAL
    return torch.sum(torch.where(hit, t, torch.zeros_like(t)) * torch.as_tensor(w))


def test_oracle_forward_matches_jax(scene):
    js = scene.js
    t_ref = j_diff(scene.jp.scene, js.obstacle_pos, js.obstacle_quat, js.pos, js.quat,
                   jnp.asarray(scene.dirs), MAX_RANGE, "oracle")
    ts = scene.ts
    t = raycast_depth_diff(scene.sc, ts.obstacle_pos, ts.obstacle_quat, ts.pos, ts.quat,
                           scene.t_dirs, MAX_RANGE, "oracle")
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=DEPTH_ATOL, rtol=0)
    assert (t < t_oracle.NO_HIT_RAY_VAL).any(), "the scene should give some hits"


def test_kernel_modes_match_oracle(scene):
    """"kernel" (raycast_reference on CPU tensors) within 1e-4 of the
    oracle; "pallas" and "interpret" are its names from the JAX package,
    and "auto" is the oracle on the CPU."""
    ts = scene.ts
    run = lambda mode: raycast_depth_diff(scene.sc, ts.obstacle_pos, ts.obstacle_quat, ts.pos,
                                          ts.quat, scene.t_dirs, MAX_RANGE, mode)
    t_orc, t_ker = run("oracle"), run("kernel")
    np.testing.assert_allclose(t_ker.numpy(), t_orc.numpy(), atol=1e-4, rtol=0)
    assert torch.equal(run("pallas"), t_ker) and torch.equal(run("interpret"), t_ker)
    assert torch.equal(run("auto"), t_orc)
    grid = scene.t_dirs.reshape(8, 128, 3)        # a sensor's (H, W, 3) grid
    for mode, t in (("kernel", t_ker), ("oracle", t_orc)):
        assert torch.equal(raycast_depth_diff(scene.sc, ts.obstacle_pos, ts.obstacle_quat,
                                              ts.pos, ts.quat, grid, MAX_RANGE, mode), t)
    with pytest.raises(ValueError, match="unknown mode"):
        run("xla")


def test_gradients_match_jax(scene):
    """d/d obstacle_pos, obstacle_quat, origin and quat of a weighted sum of
    hit depths, against jax.grad of JAX's custom VJP; the ray table gets a
    zero gradient."""
    js, ts, w = scene.js, scene.ts, scene.w

    def f(op, oq, o, q):
        t = j_diff(scene.jp.scene, op, oq, o, q, jnp.asarray(scene.dirs), MAX_RANGE, "oracle")
        return jnp.sum(jnp.where(t < t_oracle.NO_HIT_RAY_VAL, t, 0.0) * w)

    g_ref = jax.grad(f, argnums=(0, 1, 2, 3))(js.obstacle_pos, js.obstacle_quat, js.pos,
                                              js.quat)
    poses = _poses(ts)
    dirs = scene.t_dirs.clone().requires_grad_(True)
    _weighted_hits(raycast_depth_diff(scene.sc, *poses, dirs, MAX_RANGE, "kernel"),
                   w).backward()
    for name, p, ref in zip(("obstacle_pos", "obstacle_quat", "origin", "quat"), poses, g_ref):
        ref = np.asarray(ref)
        assert np.isfinite(p.grad.numpy()).all(), name
        scale = np.abs(ref).max()
        assert scale > 0.0, f"no gradient signal in {name}"
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-3 * scale, rtol=0,
                                   err_msg=name)
    assert torch.equal(dirs.grad, torch.zeros_like(dirs))


def test_gradient_matches_finite_difference(scene):
    ts, w = scene.ts, scene.w

    def f(op):
        return _weighted_hits(raycast_depth_diff(scene.sc, op, ts.obstacle_quat, ts.pos, ts.quat,
                                                 scene.t_dirs, MAX_RANGE, "kernel"), w)

    op = ts.obstacle_pos.clone().requires_grad_(True)
    f(op).backward()
    g = op.grad.numpy()
    idx = np.unravel_index(int(np.abs(g).argmax()), g.shape)
    eps = 1e-3
    opp, opm = ts.obstacle_pos.clone(), ts.obstacle_pos.clone()
    opp[idx] += eps
    opm[idx] -= eps
    fd = (float(f(opp)) - float(f(opm))) / (2 * eps)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=0.05, atol=1e-2)


def test_inverse_rendering_recovers_pose(scene):
    """Adam on the obstacle positions to match a target depth image, from a
    seeded 0.15 m perturbation (tests/test_raycast_diff.py's recipe, 60
    steps to 1% where JAX takes 150 to 5%)."""
    ts = scene.ts
    render = lambda op: raycast_depth_diff(scene.sc, op, ts.obstacle_quat, ts.pos, ts.quat,
                                           scene.t_dirs, MAX_RANGE)
    target = render(ts.obstacle_pos)
    hit = target < t_oracle.NO_HIT_RAY_VAL
    rs = np.random.RandomState(0)
    op = (ts.obstacle_pos + 0.15 * torch.from_numpy(
        rs.standard_normal(tuple(ts.obstacle_pos.shape)).astype(np.float32))).requires_grad_(True)
    opt = torch.optim.Adam([op], lr=0.02, foreach=False)
    loss_fn = lambda: torch.mean(torch.where(hit, (render(op) - target) ** 2,
                                             torch.zeros_like(target)))
    with torch.no_grad():
        l0 = float(loss_fn())
    for _ in range(60):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
    final = loss.detach().item()
    assert final < 0.01 * l0, f"inverse rendering stalled: {l0} -> {final}"


def _nan_free_grads(scene, op, oq, o, q, dirs):
    """Backprop a weighted sum of hit depths through ops/raycast.raycast_batched
    -> the number of NaN entries in each pose gradient."""
    poses = [x.clone().requires_grad_(True) for x in (op, oq, o, q)]
    rd = quat_rotate(poses[3][:, None, :], dirs[None])
    t, _ = t_oracle.raycast_batched(scene, poses[0], poses[1], poses[2], rd, MAX_RANGE)
    w = torch.sin(torch.arange(dirs.shape[0], dtype=torch.float32) * 0.37)
    _weighted_hits(t, w).backward()
    return [int(torch.isnan(p.grad).sum()) for p in poses], t


def test_oracle_gradient_finite_on_obstacle_scene():
    """C6: sqrt(max(disc, 0)) in ray_sphere / ray_cylinder has an infinite
    slope where disc is exactly 0, which a parked obstacle's zero-size
    primitive gives some rays: 9 NaN entries in d/d obstacle_pos and 3 in
    d/d origin on the port's own 2-env obstacle scene (seed 7); safe_sqrt
    gives finite gradients, as in the JAX package."""
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                      "lee_velocity_control", num_envs=2, seed=7, device="cpu")
    env.reset()
    st = env.state
    nans, t = _nan_free_grads(env.params.scene, st.obstacle_pos, st.obstacle_quat, st.pos,
                              st.quat, torch.from_numpy(_ray_table()))
    assert (t < t_oracle.NO_HIT_RAY_VAL).any()
    assert nans == [0, 0, 0, 0]


def test_oracle_gradient_finite_on_synthetic_spheres_and_cylinders():
    """Seeded spheres and cylinders in front of rays of which most miss
    them, one of each kind parked at -1000 with zero size as a culled
    obstacle is."""
    rs = np.random.RandomState(0)
    N, P = 2, 8
    kind = np.array([2] * 4 + [1] * 4, np.int32)
    size = np.concatenate([rs.uniform(0.2, 0.8, (N, P, 1)), rs.uniform(0.5, 2.0, (N, P, 1)),
                           np.zeros((N, P, 1))], axis=-1).astype(np.float32)
    op = rs.uniform(-3.0, 3.0, (N, P, 3)).astype(np.float32)
    op[..., 2] = rs.uniform(3.0, 8.0, (N, P))
    size[:, [1, 6]] = 0.0
    op[:, [1, 6]] = -1000.0
    oq = rs.standard_normal((N, P, 4)).astype(np.float32)
    oq /= np.linalg.norm(oq, axis=-1, keepdims=True)
    sc = SimpleNamespace(
        env_prim_kind=torch.from_numpy(np.tile(kind, (N, 1))),
        env_prim_size=torch.from_numpy(size),
        env_prim_pos=torch.zeros((N, P, 3)),
        env_prim_rot=torch.eye(3).expand(N, P, 3, 3).contiguous(),
        env_prim_semantic=torch.arange(P, dtype=torch.int32).expand(N, P).contiguous(),
        env_prim_slot=torch.arange(P).expand(N, P).contiguous())
    q = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (N, 1))
    nans, t = _nan_free_grads(sc, torch.from_numpy(op), torch.from_numpy(oq),
                              torch.zeros((N, 3)), torch.from_numpy(q),
                              torch.from_numpy(_ray_table(16, 64)))
    hits = (t < t_oracle.NO_HIT_RAY_VAL).float().mean().item()
    assert 0.0 < hits < 0.5, hits
    assert nans == [0, 0, 0, 0]
