"""Port parity: the ray-cast kernel's plain version (raycast_reference), the
port's ray-cast oracle and the broad phase, against the JAX oracle
(ops/raycast.raycast_batched) and the Pallas kernel in interpret mode, on
the scenes of tests/test_raycast_pallas.py.

Tolerances: depth atol 2e-3 and seg agreement > 0.999 on hit pixels, the
same bar the JAX package holds its Pallas kernel to. The port packs world-
frame primitive tables while the JAX oracle works in each asset's frame,
so the two round differently (~1e-6 m); a ray grazing an edge can flip.

The kernel itself runs only on the card; tests/test_torch_kernels.py
holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.ops import raycast as j_oracle
from aerial_gym_simulator_tpu.ops import raycast_pallas as j_pallas
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder
from aerial_gym_simulator_tpu.utils.math import quat_rotate as j_quat_rotate

from aerial_gym_simulator_tpu_torch.ops import raycast as t_oracle
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DEPTH_ATOL = 2e-3
SEG_AGREE = 0.999


def _dirs(H=8, W=128):
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, H), np.linspace(-0.6, 0.6, W),
                         indexing="ij")
    d = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _build(num_envs, seed, shift=None, park_half=False):
    env = JSimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                  "lee_velocity_control", num_envs=num_envs, seed=seed)
    env.reset()
    state = env.state
    if shift is not None:
        state = state.replace(pos=state.pos + jnp.asarray(shift, jnp.float32))
    if park_half:
        A = state.obstacle_pos.shape[1]
        state = state.replace(obstacle_pos=state.obstacle_pos.at[:, A // 2:, :].set(-1000.0))
    return env.params, state


SCENES = {
    "full_scene": dict(num_envs=3, seed=7),
    "culled_obstacles": dict(num_envs=3, seed=7, park_half=True),
    "boundary_primitive": dict(num_envs=2, seed=3, shift=[[-9.0, 0.0, 0.0]]),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    jp, js = _build(**SCENES[request.param])
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    dirs = _dirs()
    sc = tp.scene
    pose = rc.pack_pose(ts.pos, ts.quat)
    prims = rc.pack_prims_world(sc, ts.obstacle_pos, ts.obstacle_quat)
    return dict(jp=jp, js=js, tp=tp, ts=ts, dirs=dirs, pose=pose, prims=prims,
                counts=(sc.n_box, sc.n_cyl, sc.n_sph), n_tri=sc.n_tri)


def _jax_oracle(jp, js, dirs, max_range=10.0):
    rd = j_quat_rotate(js.quat[:, None, :], jnp.asarray(dirs)[None])
    t, s = j_oracle.raycast_batched(jp.scene, js.obstacle_pos, js.obstacle_quat,
                                    js.pos, rd, max_range)
    return np.asarray(t), np.asarray(s)


@pytest.fixture(scope="module")
def jax_oracle(scene):
    """The JAX oracle's (depth, seg) on the scene's rays, computed once for
    the tests that hold a port version to it."""
    return _jax_oracle(scene["jp"], scene["js"], scene["dirs"])


def _assert_match(depth, seg, t_ref, s_ref):
    np.testing.assert_allclose(depth, t_ref, atol=DEPTH_ATOL, rtol=0)
    hit = t_ref < j_oracle.NO_HIT_RAY_VAL * 0.9
    assert hit.any()
    if seg is not None:
        assert (seg[hit] == s_ref[hit]).mean() > SEG_AGREE
        assert (seg[~hit] == j_oracle.NO_HIT_SEGMENTATION_VAL).all()


@pytest.mark.parametrize("want_seg", [True, False])
def test_reference_matches_jax_oracle(scene, jax_oracle, want_seg):
    ones = torch.ones(scene["dirs"].shape[0])
    depth, seg = rc.raycast_reference(scene["pose"], scene["prims"],
                                      torch.from_numpy(scene["dirs"]), ones,
                                      *scene["counts"], 10.0, want_seg=want_seg,
                                      n_tri=scene["n_tri"])
    assert (seg is None) == (not want_seg)
    t_ref, s_ref = jax_oracle
    _assert_match(depth.numpy(), None if seg is None else seg.numpy(), t_ref, s_ref)


@pytest.mark.parametrize("want_seg", [True, False])
def test_reference_matches_pallas_interpret(scene, want_seg):
    jp, js, dirs = scene["jp"], scene["js"], scene["dirs"]
    sc = jp.scene
    ones_j = jnp.ones((dirs.shape[0],), jnp.float32)
    prims_j = j_pallas.pack_prims_world(sc, js.obstacle_pos, js.obstacle_quat)
    t_pal, s_pal = j_pallas.raycast_pallas(
        j_pallas.pack_pose(js.pos, js.quat), prims_j, jnp.asarray(dirs), ones_j,
        sc.n_box, sc.n_cyl, sc.n_sph, 10.0, want_seg=want_seg, n_tri=sc.n_tri,
        interpret=True)
    depth, seg = rc.raycast(scene["pose"], scene["prims"], torch.from_numpy(dirs),
                            torch.ones(dirs.shape[0]), *scene["counts"], 10.0,
                            want_seg=want_seg, n_tri=scene["n_tri"])
    np.testing.assert_allclose(depth.numpy(), np.asarray(t_pal), atol=DEPTH_ATOL, rtol=0)
    if want_seg:
        hit = np.asarray(t_pal) < j_oracle.NO_HIT_RAY_VAL * 0.9
        assert (seg.numpy()[hit] == np.asarray(s_pal)[hit]).mean() > SEG_AGREE
    else:
        assert seg is None and s_pal is None


def test_port_oracle_matches_jax_oracle(scene, jax_oracle):
    """ops/raycast.raycast_batched (asset-frame formulation) vs JAX's."""
    ts, dirs = scene["ts"], scene["dirs"]
    from aerial_gym_simulator_tpu_torch.utils.math import quat_rotate
    rd = quat_rotate(ts.quat[:, None, :], torch.from_numpy(dirs)[None])
    t, s = t_oracle.raycast_batched(scene["tp"].scene, ts.obstacle_pos, ts.obstacle_quat,
                                    ts.pos, rd, 10.0)
    t_ref, s_ref = jax_oracle
    _assert_match(t.numpy(), s.numpy(), t_ref, s_ref)


def test_broad_phase_is_conservative(scene):
    """Every primitive that some ray of a warp's 8 x 8 patch hits (t <
    max_range) must be visible to that warp in the kernel's broad phase
    (plain mirror), on the 8 x 128 ray grid."""
    pose, prims = scene["pose"], scene["prims"]
    dirs = torch.from_numpy(scene["dirs"]).reshape(8, 128, 3)
    nb, nc, ns = scene["counts"]
    vis = rc.tile_visibility(pose, prims, dirs, nb, nc, ns, 10.0)       # (N, G, P)
    N, R, P = pose.shape[0], 8 * 128, prims.shape[1]
    tile = rc.warp_groups(8, 128)
    culled_somewhere = 0
    for p in range(P):
        # this primitive alone, as a one-column table of its kind
        counts = [0, 0, 0, 0]
        counts[rc._kind_of(p, nb, nc, ns)] = 1
        depth, _ = rc.raycast_reference(pose, prims[:, p:p + 1].contiguous(), dirs,
                                        torch.ones(R), *counts[:3], 10.0, want_seg=False,
                                        n_tri=counts[3])
        hit = depth < 10.0                                               # (N, R)
        assert vis[:, :, p][torch.arange(N)[:, None], tile[None, :]][hit].all(), p
        culled_somewhere += int((~vis[:, :, p]).sum())
    assert culled_somewhere > 0          # the broad phase does remove work


def test_render_dispatch_uses_reference_on_cpu(scene):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    before = dict(rc.LAUNCHES)
    dirs = torch.from_numpy(scene["dirs"])
    a = rc.raycast(scene["pose"], scene["prims"], dirs, torch.ones(dirs.shape[0]),
                   *scene["counts"], 10.0, n_tri=scene["n_tri"])
    b = rc.raycast_reference(scene["pose"], scene["prims"], dirs, torch.ones(dirs.shape[0]),
                             *scene["counts"], 10.0, n_tri=scene["n_tri"])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert rc.LAUNCHES == before
