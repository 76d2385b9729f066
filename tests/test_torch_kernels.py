"""The ray-cast kernel (csrc/raycast.cu) in its four modes and the
fused-attention forward and backward kernels (csrc/attention.cu) against
their plain PyTorch versions, and the wrappers' contracts. This file imports only the port, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q -m cuda    # on the card

Tests marked ``cuda`` launch the kernel; without a GPU they skip. On the
CPU the remaining tests check the wrapper, the plain version and the broad
phase on a seeded synthetic scene.

Tolerances (kernel vs plain version): depth max-abs-err 2e-3 and seg
agreement >= 0.999 on hit pixels; both evaluate the same expressions in
the same order, so the difference is expected to be 0. Broad phase on and
off must give bit-identical images. The normal (K3) and RGB (K4) modes:
depth, seg and face bit-equal to the plain version, normals and rgb within
1e-6 (the same expressions in the same order, IEEE division and square
root on both sides, so 0 is expected), exact sentinels on a miss. Attention: f32 atol/rtol 1e-4 (the
kernel sums in another order than the matrix products of the plain
version), bf16 atol/rtol 0.05 (the probabilities are rounded to bf16 at
another place). Attention backward: f32 atol/rtol 2e-4, the bar the JAX
package holds its own backward kernel to; bf16 atol/rtol 0.02 (both sides
compute in f32 from the same bf16 inputs and round the result once; five
times the 0.004 seen on an H100 at S = 225); two launches on the same
inputs give the same bits (no atomics).
"""

import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
from aerial_gym_simulator_tpu_torch.ops.attention import (
    attention_backward_reference, attention_lse_reference, attention_reference)
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
    camera_ray_dirs, lidar_ray_dirs)
from aerial_gym_simulator_tpu_torch.utils.math import quat_to_rotation_matrix


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
MAX_RANGE = 12.0
COUNTS = (12, 8, 4, 300)      # box, cylinder, sphere, triangle: 324 > one chunk


def synthetic_scene(device, n_envs=3, seed=7, H=24, W=40, lidar=False, grid=False):
    """Seeded world-frame soup of all four kinds; ~10% of the primitives
    parked at -1000 with zero size, as culled obstacles and padding are.
    The rays are a camera's, or with ``lidar`` a 360-degree lidar's; dirs
    (R, 3) and mult (R,), or with ``grid`` the (H, W, 3) and (H, W) grid."""
    g = torch.Generator().manual_seed(seed)
    P = sum(COUNTS)
    size = torch.rand((n_envs, P, 3), generator=g) * 1.2 + 0.05
    s0 = COUNTS[0] + COUNTS[1]
    size[:, s0:s0 + COUNTS[2], 1:] = 0.0
    pos = (torch.rand((n_envs, P, 3), generator=g) - 0.5) * 16.0
    q = torch.randn((n_envs, P, 4), generator=g)
    rot = quat_to_rotation_matrix(q / q.norm(dim=-1, keepdim=True))
    sem = torch.randint(0, 50, (n_envs, P), generator=g).float()
    parked = torch.rand((n_envs, P), generator=g) < 0.1
    size[parked] = 0.0
    pos[parked] = -1000.0
    prims = torch.cat([size, pos, rot.reshape(n_envs, P, 9), sem[..., None]], dim=-1)
    qs = torch.randn((n_envs, 4), generator=g)
    pose = rc.pack_pose((torch.rand((n_envs, 3), generator=g) - 0.5) * 4.0,
                        qs / qs.norm(dim=-1, keepdim=True))
    dirs, mult = (lidar_ray_dirs(H, W, -180.0, 180.0, -45.0, 45.0) if lidar
                  else camera_ray_dirs(H, W, 87.0))
    as_t = lambda x: (torch.as_tensor(x) if grid else
                      torch.as_tensor(x).reshape(-1, *x.shape[2:])).contiguous().to(device)
    return (pose.to(device), prims.contiguous().to(device), as_t(dirs), as_t(mult))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this check on the H100")
    return torch.device("cuda")


def _run(fn, args, **kw):
    return fn(*args, *COUNTS[:3], MAX_RANGE, n_tri=COUNTS[3], **kw)


# ---------------------------------------------------------------------------
# CPU: wrapper, plain version, broad phase
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version():
    args = synthetic_scene("cpu")
    before = dict(rc.LAUNCHES)
    d, s = _run(rc.raycast, args)
    d_r, s_r = _run(rc.raycast_reference, args)
    assert torch.equal(d, d_r) and torch.equal(s, s_r)
    assert rc.LAUNCHES == before
    hit = s != -2
    assert 0.05 < hit.float().mean() < 0.95          # hits and misses both
    assert torch.equal(d[~hit], 1000.0 * args[3].expand_as(d)[~hit])


def test_depth_only_mode_matches_seg_mode_depth():
    args = synthetic_scene("cpu")
    d0, s0 = _run(rc.raycast, args, want_seg=False)
    d1, _ = _run(rc.raycast, args, want_seg=True)
    assert s0 is None and torch.equal(d0, d1)


def test_env_chunking_does_not_change_the_plain_version(monkeypatch):
    args = synthetic_scene("cpu")
    a = _run(rc.raycast_reference, args)
    monkeypatch.setattr(rc, "REFERENCE_CHUNK_RAYS", 1)          # one env per pass
    b = _run(rc.raycast_reference, args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_parked_primitives_never_hit():
    pose, prims, dirs, mult = synthetic_scene("cpu")
    parked = prims.clone()
    parked[..., 0:3] = 0.0
    parked[..., 3:6] = -1000.0
    d, s = _run(rc.raycast, (pose, parked, dirs, mult))
    assert (s == -2).all() and torch.equal(d, 1000.0 * mult.expand_as(d))


def _assert_conservative(pose, prims, dirs, mult, counts, max_range):
    """No primitive that a ray hits alone (t < max_range) is culled for the
    warp patch that holds the ray, in the plain twin of the kernel's broad
    phase; and the broad phase does cull something."""
    vis = rc.tile_visibility(pose, prims, dirs, *counts[:3], max_range)  # (N, G, P)
    N, P = pose.shape[0], prims.shape[1]
    tile = rc.warp_groups(*rc.ray_grid(dirs))
    assert vis.shape == (N, int(tile.max()) + 1, P)
    for p in range(P):
        # this primitive alone, as a one-column table of its kind
        one = [0, 0, 0, 0]
        one[rc._kind_of(p, *counts[:3])] = 1
        d, _ = rc.raycast_reference(pose, prims[:, p:p + 1].contiguous(), dirs, mult,
                                    *one[:3], max_range, want_seg=False, n_tri=one[3])
        hit = d < max_range * mult.reshape(-1)
        assert vis[:, :, p][torch.arange(N)[:, None], tile[None, :]][hit].all(), p
    assert (~vis).any()


def test_broad_phase_is_conservative_on_synthetic_scene():
    pose, prims, dirs, mult = synthetic_scene("cpu", n_envs=2, grid=True)
    _assert_conservative(pose, prims, dirs, mult, COUNTS, MAX_RANGE)


def _obstacle_env_inputs(robot, n_envs=2, steps=3):
    """The kernel's inputs as a capture packs them, from the obstacle env
    on the CPU: ((pose, prims, dirs (H, W, 3), mult (H, W)), counts, range)."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", robot,
                                      "lee_velocity_control", num_envs=n_envs, seed=2,
                                      device="cpu")
    for _ in range(steps):
        env.step(torch.zeros((n_envs, 4)))
    st = env.state
    sp = env.params.lidar if "lidar" in robot else env.params.camera
    mount = ((st.lidar_mount_pos, st.lidar_mount_quat) if "lidar" in robot
             else (st.cam_mount_pos, st.cam_mount_quat))
    a = cast_inputs(env.params, st, sp, *mount)
    return a[:4], (a[4], a[5], a[6], env.params.scene.n_tri), a[7]


def test_broad_phase_is_conservative_on_the_obstacle_camera():
    """The 135 x 240 camera: 135 rows are 8 patches of 16 and 7 rows, so the
    last row of warp patches is ragged."""
    args, counts, max_range = _obstacle_env_inputs("base_quadrotor_with_camera")
    assert tuple(args[2].shape) == (135, 240, 3)
    _assert_conservative(*args, counts, max_range)


@pytest.mark.parametrize("H", [8, 128])
def test_broad_phase_is_conservative_on_lidar_grids(H):
    """360-degree lidar grids of 512 columns: a warp patch spans about 6
    degrees of azimuth and of elevation at 128 rows, 45 degrees of
    elevation at 8."""
    pose, prims, dirs, mult = synthetic_scene("cpu", n_envs=1 if H > 8 else 2, H=H, W=512,
                                              lidar=True, grid=True)
    _assert_conservative(pose, prims, dirs, mult, COUNTS, MAX_RANGE)


@pytest.mark.parametrize("H,W", [(13, 21), (17, 33), (1, 50)])
def test_broad_phase_is_conservative_on_ragged_grids(H, W):
    pose, prims, dirs, mult = synthetic_scene("cpu", n_envs=2, H=H, W=W, grid=True)
    _assert_conservative(pose, prims, dirs, mult, COUNTS, MAX_RANGE)


def test_grid_and_flat_ray_tables_give_equal_outputs():
    """dirs (H, W, 3) with mult (H, W), and the same rays as (R, 3) and
    (R,), in every mode."""
    grid = synthetic_scene("cpu", H=13, W=21, grid=True)
    flat = synthetic_scene("cpu", H=13, W=21)
    assert torch.equal(grid[2].reshape(-1, 3), flat[2])
    for kw in ({"want_seg": False}, {}, {"want_normals": True}, {"want_rgb": True}):
        a, b = _run(rc.raycast, grid, **kw), _run(rc.raycast, flat, **kw)
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b)), kw
        assert a[0].shape == (3, 13 * 21)


def test_tiling_free_count_is_below_every_broad_phase():
    """The tests that a broad phase on these bounding spheres could not skip
    (a ray's half-line meets the sphere within range) are a subset of what the
    kernel's warp patches keep and of what 256-ray strips kept: per env and
    primitive, the ray count is never above either."""
    for robot in ("base_quadrotor_with_camera", "base_quadrotor_with_lidar"):
        (pose, prims, dirs, mult), counts, max_range = _obstacle_env_inputs(robot)
        need = rc.bounding_sphere_hits(pose, prims, dirs, *counts[:3], max_range)  # (N, P)
        R = dirs.shape[0] * dirs.shape[1]
        for groups in (rc.warp_groups(*rc.ray_grid(dirs)), torch.arange(R) // 256):
            vis = rc.tile_visibility(pose, prims, dirs, *counts[:3], max_range, groups)
            size = torch.bincount(groups).float()
            kept = (vis.float() * size[None, :, None]).sum(dim=1)          # (N, P)
            assert (need <= kept).all(), robot
        assert need.sum() > 0 and (need < R).any()


def test_wrapper_rejects_bad_inputs():
    pose, prims, dirs, mult = synthetic_scene("cpu")
    with pytest.raises(ValueError):
        rc.raycast(pose, prims, dirs, mult, 1, 1, 0, MAX_RANGE)        # counts != P


def test_normal_and_rgb_modes_on_cpu_tensors():
    """The plain normal and RGB modes: shapes, sentinels on a miss, unit
    normals, rgb in [0, 1]; both modes at once raise; nothing launches."""
    args = synthetic_scene("cpu")
    before = dict(rc.LAUNCHES)
    d, s, n, f = _run(rc.raycast, args, want_normals=True)
    d2, s2 = _run(rc.raycast, args)
    assert torch.equal(d, d2) and torch.equal(s, s2)
    hit = f >= 0
    assert 0.05 < hit.float().mean() < 0.95 and torch.equal(hit, s != -2)
    assert (n[~hit] == 0.0).all()
    torch.testing.assert_close(n[hit].norm(dim=-1), torch.ones(int(hit.sum())))
    assert ((f[hit] >= 0) & (f[hit] < sum(COUNTS))).all()
    d3, s3, rgb = _run(rc.raycast, args, want_rgb=True)
    assert torch.equal(s3, s) and (d3[~hit] == 1000.0).all()
    assert torch.equal(d3[hit], d[hit])
    sky = torch.as_tensor(rc.oracle.SKY_RGB)
    assert (rgb[~hit] == sky).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0
    assert rc.LAUNCHES == before
    with pytest.raises(ValueError, match="exclusive"):
        _run(rc.raycast, args, want_normals=True, want_rgb=True)


def test_env_chunking_does_not_change_normal_and_rgb_modes(monkeypatch):
    args = synthetic_scene("cpu", n_envs=2, H=8, W=16)
    a = _run(rc.raycast_reference, args, want_normals=True)
    b = _run(rc.raycast_reference, args, want_rgb=True)
    monkeypatch.setattr(rc, "REFERENCE_CHUNK_RAYS", 1)          # one env per pass
    assert all(torch.equal(x, y) for x, y in
               zip(a + b, _run(rc.raycast_reference, args, want_normals=True)
                   + _run(rc.raycast_reference, args, want_rgb=True)))


def test_broad_phase_is_conservative_on_a_lidar_table():
    """A 360-degree scan of 3 x 512 rays: the warp patches hold 3 rows, and
    a patch's cone is narrow in azimuth, wide in elevation."""
    pose, prims, dirs, mult = synthetic_scene("cpu", n_envs=2, H=3, W=512, lidar=True,
                                              grid=True)
    _assert_conservative(pose, prims, dirs, mult, COUNTS, MAX_RANGE)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("want_seg", [False, True])
def test_kernel_matches_plain_version_synthetic(cuda_device, want_seg):
    args = synthetic_scene(cuda_device)
    name = "raycast_seg" if want_seg else "raycast_depth"
    before = rc.LAUNCHES[name]
    d_k, s_k = _run(rc.raycast, args, want_seg=want_seg)
    d_n, s_n = _run(rc.raycast, args, want_seg=want_seg, cull=False)
    d_r, s_r = _run(rc.raycast_reference, args, want_seg=want_seg)
    torch.cuda.synchronize()
    assert rc.LAUNCHES[name] == before + 2
    assert torch.equal(d_k, d_n)
    assert (d_k - d_r).abs().max().item() <= DEPTH_ATOL
    if want_seg:
        assert torch.equal(s_k, s_n)
        hit = s_r != -2
        assert (s_k[hit] == s_r[hit]).float().mean().item() >= SEG_AGREE


@pytest.mark.cuda
def test_kernel_matches_plain_version_obstacle_env(cuda_device):
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import sensor_world_pose
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=4, seed=1)
    for _ in range(5):
        env.step(torch.zeros((4, 4), device=cuda_device))
    sp, sc, st = env.params.camera, env.params.scene, env.state
    pos_w, quat_w = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    R = sp.height * sp.width
    args = (rc.pack_pose(pos_w, quat_w),
            rc.pack_prims_world(sc, st.obstacle_pos, st.obstacle_quat),
            sp.dirs.reshape(R, 3), sp.depth_multiplier.reshape(R))
    counts = (sc.n_box, sc.n_cyl, sc.n_sph, sp.max_range)
    d_k, s_k = rc.raycast(*args, *counts, n_tri=sc.n_tri)
    d_r, s_r = rc.raycast_reference(*args, *counts, n_tri=sc.n_tri)
    torch.cuda.synchronize()
    assert (d_k - d_r).abs().max().item() <= DEPTH_ATOL
    hit = s_r != -2
    assert (s_k[hit] == s_r[hit]).float().mean().item() >= SEG_AGREE


@pytest.mark.cuda
def test_inflated_render_launches_the_seg_kernel_bit_equal(cuda_device):
    """render_inflated_depth on the card: one K2 launch on the inflated
    table, its depth and seg bit-equal to the plain version's."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    from aerial_gym_simulator_tpu_torch.utils.collision_image_generator import (
        inflate_scene, render_inflated_depth)
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=4, seed=2)
    for _ in range(5):
        env.step(torch.zeros((4, 4), device=cuda_device))
    params, st = env.params, env.state
    before = rc.LAUNCHES["raycast_seg"]
    depth, seg = render_inflated_depth(params, st)
    assert rc.LAUNCHES["raycast_seg"] == before + 1
    sp = params.camera
    inflated = replace(params, scene=inflate_scene(params.scene, params.robot.collision_radius))
    d_r, s_r = rc.raycast_reference(*cast_inputs(inflated, st, sp, st.cam_mount_pos,
                                                 st.cam_mount_quat),
                                    n_tri=inflated.scene.n_tri)
    torch.cuda.synchronize()
    assert torch.equal(depth.reshape(d_r.shape), d_r) and torch.equal(seg.reshape(s_r.shape), s_r)


@pytest.mark.cuda
def test_kernel_wrapper_checks_on_card(cuda_device):
    pose, prims, dirs, mult = synthetic_scene(cuda_device)
    with pytest.raises(ValueError):
        _run(rc.raycast, (pose, prims, dirs.double(), mult))
    with pytest.raises(ValueError):
        _run(rc.raycast, (pose, prims[:, ::2].contiguous(), dirs, mult))
    with pytest.raises(ValueError):
        _run(rc.raycast, (pose, prims, dirs.cpu(), mult))


def _compare_modes(args, counts, n_tri):
    """Normal and RGB modes, kernel (cull on and off) vs plain version."""
    for mode, name in (("want_normals", "raycast_normals"), ("want_rgb", "raycast_rgb")):
        before = rc.LAUNCHES[name]
        k = rc.raycast(*args, *counts, n_tri=n_tri, **{mode: True})
        k_off = rc.raycast(*args, *counts, n_tri=n_tri, cull=False, **{mode: True})
        ref = rc.raycast_reference(*args, *counts, n_tri=n_tri, **{mode: True})
        torch.cuda.synchronize()
        assert rc.LAUNCHES[name] == before + 2
        for a, b in zip(k, k_off):
            assert torch.equal(a, b), name
        depth, seg = k[0], k[1]
        assert torch.equal(depth, ref[0]) and torch.equal(seg, ref[1]), name
        hit = seg != -2
        assert hit.any() and (~hit).any()
        if mode == "want_normals":
            normal, face = k[2], k[3]
            assert torch.equal(face, ref[3]) and (face[~hit] == -1).all()
            assert (normal[~hit] == 0.0).all()
            assert (normal - ref[2]).abs().max().item() <= 1e-6
        else:
            rgb = k[2]
            assert (depth[~hit] == 1000.0).all()
            assert (rgb[~hit] == torch.as_tensor(rc.oracle.SKY_RGB, device=rgb.device)).all()
            assert rgb.min() >= 0.0 and rgb.max() <= 1.0
            assert (rgb - ref[2]).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("lidar", [False, True], ids=["camera", "lidar"])
def test_normal_and_rgb_kernels_match_plain_version_synthetic(cuda_device, lidar):
    args = (synthetic_scene(cuda_device, H=8, W=512, lidar=True) if lidar
            else synthetic_scene(cuda_device))
    _compare_modes(args, COUNTS[:3] + (MAX_RANGE,), COUNTS[3])


@pytest.mark.cuda
def test_normal_and_rgb_kernels_match_plain_version_obstacle_env(cuda_device):
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import sensor_world_pose
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_faceid_normal_camera",
                                      "lee_velocity_control", num_envs=4, seed=1)
    for _ in range(5):
        env.step(torch.zeros((4, 4), device=cuda_device))
    sp, sc, st = env.params.camera, env.params.scene, env.state
    pos_w, quat_w = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    R = sp.height * sp.width
    args = (rc.pack_pose(pos_w, quat_w),
            rc.pack_prims_world(sc, st.obstacle_pos, st.obstacle_quat),
            sp.dirs.reshape(R, 3), sp.depth_multiplier.reshape(R))
    # a 4 m range leaves misses in the enclosed env
    _compare_modes(args, (sc.n_box, sc.n_cyl, sc.n_sph, 4.0), sc.n_tri)


@pytest.mark.cuda
def test_normal_and_rgb_wrapper_checks_on_card(cuda_device):
    pose, prims, dirs, mult = synthetic_scene(cuda_device)
    for mode in ("want_normals", "want_rgb"):
        with pytest.raises(ValueError):
            _run(rc.raycast, (pose, prims, dirs, mult.double()), **{mode: True})
        with pytest.raises(ValueError):
            _run(rc.raycast, (pose, prims.transpose(0, 1).contiguous().transpose(0, 1), dirs,
                              mult), **{mode: True})
    with pytest.raises(ValueError, match="exclusive"):
        _run(rc.raycast, (pose, prims, dirs, mult), want_normals=True, want_rgb=True)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,lidar", [(135, 240, False), (8, 512, True)],
                         ids=["camera135x240", "lidar8x512"])
@pytest.mark.parametrize("as_grid", [True, False], ids=["grid", "flat"])
def test_all_modes_bit_equal_on_ragged_grids(cuda_device, H, W, lidar, as_grid):
    """Every mode of the kernel against the plain version with torch.equal
    on grids whose rows or columns are not a multiple of the 16 x 32 patch
    (135 = 8 x 16 + 7 rows; an (R, 3) table is one row of R), with the
    broad phase on and off, and the grid and the flat table give the same
    images."""
    grid = synthetic_scene(cuda_device, H=H, W=W, lidar=lidar, grid=True)
    args = grid if as_grid else (grid[0], grid[1], grid[2].reshape(-1, 3), grid[3].reshape(-1))
    for kw in ({"want_seg": False}, {}, {"want_normals": True}, {"want_rgb": True}):
        k = _run(rc.raycast, args, **kw)
        k_off = _run(rc.raycast, args, cull=False, **kw)
        ref = _run(rc.raycast_reference, args, **kw)
        other = _run(rc.raycast, grid if not as_grid else
                     (grid[0], grid[1], grid[2].reshape(-1, 3), grid[3].reshape(-1)), **kw)
        torch.cuda.synchronize()
        for a, b, c, d in zip(k, k_off, ref, other):
            if a is None:
                continue
            assert torch.equal(a, b), f"{kw}: broad phase on and off differ"
            assert torch.equal(a, c), f"{kw}: kernel and plain version differ"
            assert torch.equal(a, d), f"{kw}: grid and flat tables differ"
        hit = k[1] != -2 if k[1] is not None else k[0] < 100.0
        assert hit.any() and (~hit).any()


# ---------------------------------------------------------------------------
# fused attention forward
# ---------------------------------------------------------------------------


def qkv(shape, dtype, device, seed=0, n=3):
    """Seeded (B, S, D) q, k, v (and further tensors of that shape when n >
    3); ``shape`` is (B, S, D, num_heads)."""
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal(shape[:3]).astype(np.float32))
            .to(dtype).to(device) for _ in range(n)]


def test_attention_cpu_tensors_run_the_plain_version():
    q, k, v = qkv((2, 17, 128, 4), torch.float32, "cpu")
    before = dict(ac.LAUNCHES)
    out = ac.fused_attention(q, k, v, 4)
    assert torch.equal(out, attention_reference(q, k, v, 4))
    assert ac.LAUNCHES == before
    with pytest.raises(ValueError):
        ac.fused_attention(q, k, v, 3)                     # 128 % 3 != 0


ATTENTION_CASES = [
    ((2, 17, 128, 4), torch.float32, 1e-4),
    ((1, 225, 128, 4), torch.float32, 1e-4),
    ((3, 128, 256, 8), torch.float32, 1e-4),
    ((2, 300, 256, 8), torch.float32, 1e-4),
    ((2, 225, 256, 4), torch.float32, 1e-4),              # head_dim 64, 3xTF32
    ((2, 65, 384, 3), torch.float32, 1e-4),               # head_dim 128
    ((2, 33, 68, 4), torch.float32, 1e-4),                # head_dim 17: 4-byte copies
    ((64, 225, 256, 8), torch.bfloat16, 0.05),            # bf16 serving kernel, hd 32
    ((2, 100, 256, 4), torch.bfloat16, 0.05),             # bf16 serving kernel, hd 64
    ((2, 65, 96, 4), torch.bfloat16, 0.05),               # hd 24: TF32 kernel
    # past the staged serving kernel's shared-memory limit (S > 768 at hd 64,
    # S > 1,408 at hd 32), where its launch failed before the ring kernel
    ((2, 900, 256, 4), torch.bfloat16, 0.05),             # the ViT at 270x480, 4 heads
    ((1, 1600, 256, 8), torch.bfloat16, 0.05),            # the ring kernel at hd 32
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", ATTENTION_CASES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_attention_kernel_matches_plain_version(cuda_device, shape, dtype, tol):
    q, k, v = qkv(shape, dtype, cuda_device)
    before = ac.LAUNCHES["attention_fwd"]
    out = ac.fused_attention(q, k, v, shape[3])
    ref = attention_reference(q, k, v, shape[3])
    torch.cuda.synchronize()
    assert ac.LAUNCHES["attention_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_attention_two_kernels_agree_on_bf16(cuda_device):
    q, k, v = qkv((4, 225, 256, 8), torch.bfloat16, cuda_device, seed=3)
    a = ac.attention_forward(q, k, v, 8, use_mma=True)
    b = ac.attention_forward(q, k, v, 8, use_mma=False)
    c = ac.attention_forward(q, k, v, 8, use_mma=True, ring=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(a.float(), b.float(), atol=0.05, rtol=0.05)
    torch.testing.assert_close(c.float(), b.float(), atol=0.05, rtol=0.05)
    with pytest.raises(ValueError, match="ring"):
        ac.attention_forward(q.float(), k.float(), v.float(), 8, ring=True)


@pytest.mark.cuda
def test_attention_non_positive_scale_takes_the_f32_accurate_kernel(cuda_device):
    """The tensor-core kernel takes the row maximum before scaling, which
    needs a positive scale; any other scale runs the other kernel."""
    q, k, v = qkv((2, 65, 256, 8), torch.bfloat16, cuda_device, seed=4)
    out = ac.fused_attention(q, k, v, 8, sm_scale=-0.2)
    ref = attention_reference(q, k, v, 8, sm_scale=-0.2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=0.05, rtol=0.05)
    with pytest.raises(ValueError, match="positive scale"):
        ac.attention_forward(q, k, v, 8, sm_scale=-0.2, use_mma=True)


@pytest.mark.cuda
def test_attention_wrapper_checks_on_card(cuda_device):
    q, k, v = qkv((2, 32, 128, 4), torch.float32, cuda_device)
    with pytest.raises(ValueError):
        ac.fused_attention(q.transpose(0, 1), k, v, 4)     # not contiguous
    with pytest.raises(ValueError):
        ac.fused_attention(q.half(), k.half(), v.half(), 4)
    with pytest.raises(ValueError):
        ac.fused_attention(q, k.cpu(), v, 4)
    with pytest.raises(ValueError):
        ac.fused_attention(q, k[:, :16].contiguous(), v, 4)


# ---------------------------------------------------------------------------
# fused attention backward
# ---------------------------------------------------------------------------


def test_attention_backward_cpu_tensors_run_the_plain_version():
    q, k, v, do = qkv((2, 17, 128, 4), torch.float32, "cpu", n=4)
    before = dict(ac.LAUNCHES)
    got = ac.attention_backward(q, k, v, do.transpose(0, 1).contiguous().transpose(0, 1), 4)
    want = attention_backward_reference(q, k, v, do, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ac.LAUNCHES == before
    with pytest.raises(ValueError):
        ac.attention_backward(q, k, v, do, 3)


BACKWARD_CASES = [
    ((2, 17, 128, 4), torch.float32, 2e-4),
    ((2, 100, 64, 4), torch.float32, 2e-4),               # head_dim 16
    ((64, 225, 256, 8), torch.float32, 2e-4),             # the ViT training shape
    ((2, 100, 256, 4), torch.float32, 2e-4),              # head_dim 64, ragged
    ((2, 225, 256, 4), torch.float32, 2e-4),              # head_dim 64 at the ViT sequence
    ((2, 65, 384, 3), torch.float32, 2e-4),               # head_dim 128
    ((2, 33, 68, 4), torch.float32, 2e-4),                # head_dim 17: 4-byte copies
    ((8, 225, 256, 8), torch.bfloat16, 0.02),
    ((16, 225, 256, 8), torch.bfloat16, 0.02),            # the serving shape, 16 batch rows
    ((2, 225, 256, 4), torch.bfloat16, 0.02),             # head_dim 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", BACKWARD_CASES,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_attention_backward_kernel_matches_plain_version(cuda_device, shape, dtype, tol):
    q, k, v, do = qkv(shape, dtype, cuda_device, n=4)
    before = ac.LAUNCHES["attention_bwd"]
    got = ac.attention_backward(q, k, v, do, shape[3])
    again = ac.attention_backward(q, k, v, do, shape[3])
    want = attention_backward_reference(q, k, v, do, shape[3])
    torch.cuda.synchronize()
    assert ac.LAUNCHES["attention_bwd"] == before + 2
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == q.shape, name
        assert torch.equal(a, a2), f"{name}: two launches differ"
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_attention_autograd_runs_both_kernels(cuda_device):
    """loss.backward() through fused_attention makes one forward and one
    backward call, saves q, k, v, the output and L (nothing S x S), takes a
    non-contiguous output gradient, and agrees with autograd through the
    plain version."""
    q, k, v, w = qkv((3, 65, 128, 4), torch.float32, cuda_device, seed=2, n=4)
    for t in (q, k, v):
        t.requires_grad_(True)
    before = dict(ac.LAUNCHES)
    out = ac.fused_attention(q, k, v, 4)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(3, 65, 128)] * 4 + [(3, 4, 65)]
    assert saved[3].data_ptr() == out.data_ptr()
    torch.testing.assert_close(saved[4], attention_lse_reference(q, k, 4), atol=1e-4, rtol=1e-4)
    # the transposes hand backward an output gradient with permuted strides
    (out.transpose(0, 1) * w.transpose(0, 1)).sum().backward()
    assert ac.LAUNCHES == dict(before, attention_fwd=before["attention_fwd"] + 1,
                               attention_bwd=before["attention_bwd"] + 1)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (attention_reference(q, k, v, 4) * w).sum().backward()
    torch.cuda.synchronize()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_attention_backward_survives_adversarial_magnitudes(cuda_device):
    """q and k scaled by 30 (logits of order 1e3): gradients stay finite and
    close to the plain version. No key is padded or masked, so no 0 * inf.
    1e-2: a logit of order 1e3 carries a rounding error of order 1e-4, which
    moves P by that share, and the gradients here reach the hundreds."""
    q, k, v, do = qkv((1, 96, 64, 2), torch.float32, cuda_device, seed=4, n=4)
    q, k = q * 30.0, k * 30.0
    got = ac.attention_backward(q, k, v, do, 2)
    want = attention_backward_reference(q, k, v, do, 2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_attention_backward_runs_past_the_old_shared_memory_limit(cuda_device):
    """f32 at head_dim 64 and S = 300, which no longer has to fit one
    block's shared memory, runs both ways and matches the plain versions;
    a gradient of the wrong shape is refused."""
    q, k, v, do = qkv((1, 300, 256, 4), torch.float32, cuda_device, n=4)
    out = ac.fused_attention(q, k, v, 4)
    got = ac.attention_backward(q, k, v, do, 4)
    want = attention_backward_reference(q, k, v, do, 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_reference(q, k, v, 4), atol=1e-4, rtol=1e-4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError):
        ac.attention_backward(q, k, v, do[:, :100], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3, 225, 256, 8), torch.float32),
                                         ((3, 225, 256, 8), torch.bfloat16),
                                         ((2, 100, 256, 4), torch.bfloat16),
                                         ((2, 65, 96, 4), torch.bfloat16)],
                         ids=lambda x: str(x).replace("torch.", ""))
def test_attention_lse_matches_plain_version(cuda_device, shape, dtype):
    """L from each forward kernel (TF32 for f32 and bf16 at head_dim 24, the
    bf16 serving kernel at 32 and 64) against the plain log-sum-exp, and the
    output beside it unchanged by asking for L."""
    q, k, v = qkv(shape, dtype, cuda_device, seed=5)
    out, lse = ac.attention_forward(q, k, v, shape[3], want_lse=True)
    plain = ac.attention_forward(q, k, v, shape[3])
    torch.cuda.synchronize()
    assert lse.shape == (shape[0], shape[3], shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention_lse_reference(q, k, shape[3]), atol=1e-4, rtol=1e-4)
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True], ids=["chosen", "ring"])
@pytest.mark.parametrize("heads", [8, 4], ids=["hd32", "hd64"])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 225])
def test_serving_kernel_sequence_lengths(cuda_device, S, heads, ring):
    """The bf16 serving kernels (the one the launcher picks, and the ring
    kernel forced) at sequence lengths around the ring's 32-key chunks and
    16-row tiles, over more blocks than one wave of the card: with and
    without L against the plain versions, the same o bits either way and
    from a second call."""
    B = 384 // heads                           # 384 (batch row, head) pairs
    q, k, v = qkv((B, S, 256, heads), torch.bfloat16, cuda_device, seed=8)
    kw = dict(use_mma=True, ring=True) if ring else {}
    before = dict(ac.LAUNCHES)
    out, lse = ac.attention_forward(q, k, v, heads, want_lse=True, **kw)
    plain = ac.attention_forward(q, k, v, heads, **kw)
    again = ac.attention_forward(q, k, v, heads, **kw)
    torch.cuda.synchronize()
    assert ac.LAUNCHES == dict(before, attention_fwd=before["attention_fwd"] + 3)
    assert torch.equal(out, plain) and torch.equal(plain, again)
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, heads).float(),
                               atol=0.05, rtol=0.05)
    torch.testing.assert_close(lse, attention_lse_reference(q, k, heads), atol=1e-4, rtol=1e-4)


# heads wider than 128 columns: the one-pass wide kernels up to 256 columns,
# the cluster kernels up to 2,048, the sliced kernels above. (B, S, D, heads)
WIDE_SHAPES = [
    (2, 225, 256, 1),          # head 256, one head (ViT dim 256 at one head)
    (2, 225, 512, 2),          # head 256, two heads
    (1, 225, 512, 1),          # head 512, one head (ViT dim 512 at one head): a cluster of 2
    (1, 225, 1024, 2),         # head 512, two heads: clusters of 2
    (2, 65, 268, 2),           # head 134: 4-byte copies
    (3, 1, 256, 1),            # S = 1: the second warpgroup of the forward sees no key
    (2, 17, 256, 1),           # S = 17: one key for the second warpgroup
    (2, 65, 256, 1),           # S = 65: one key in the last tile
    (1, 300, 256, 1),          # S = 300
    (2, 100, 272, 2),          # head 136
    (2, 225, 384, 2),          # head 192
    (2, 33, 274, 2),           # head 137: odd, bf16 staged by plain loads
    (40, 225, 256, 1),         # 160 blocks a kernel: more than one wave over 132 SMs
    (2, 65, 264, 1),           # head 264: the second rank holds 8 columns
    (1, 65, 514, 2),           # head 257: odd, the second rank holds 1 column
    (1, 100, 768, 1),          # head 768: a cluster of 3
    (1, 65, 1024, 1),          # head 1,024: a cluster of 4
    (1, 33, 2048, 1),          # head 2,048: a cluster of 8, the largest
    (40, 225, 512, 1),         # 320 blocks: clusters of 2 over more than one wave
    (1, 33, 2049, 1),          # head 2,049, past the clusters' reach: the sliced kernels
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [(torch.float32, 1e-4, 2e-4),
                                                   (torch.bfloat16, 0.05, 0.02)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=str)
def test_attention_wide_heads_match_plain_version(cuda_device, shape, dtype, fwd_tol, bwd_tol):
    """Forward with and without L and the backward at head sizes above 128,
    through the kernels of the head's family (each call counted under it,
    none falls back), against the plain versions at the bars of the narrow
    heads; the forward with L gives the same bits as without it, and two
    backward calls on the same inputs give the same bits."""
    H = shape[3]
    family = ac.kernel_family(shape[2] // H)
    assert family in ("_wide", "_cluster", "_sliced")
    q, k, v, do = qkv(shape, dtype, cuda_device, seed=6, n=4)
    before = dict(ac.LAUNCHES)
    out, lse = ac.attention_forward(q, k, v, H, want_lse=True)
    plain = ac.attention_forward(q, k, v, H)
    got = ac.attention_backward(q, k, v, do, H, out=out, lse=lse)
    again = ac.attention_backward(q, k, v, do, H, out=out, lse=lse)
    torch.cuda.synchronize()
    assert ac.LAUNCHES == dict(before, **{"attention_fwd" + family:
                                          before["attention_fwd" + family] + 2,
                                          "attention_bwd" + family:
                                          before["attention_bwd" + family] + 2})
    assert torch.equal(out, plain) and out.dtype == dtype
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, H).float(),
                               atol=fwd_tol, rtol=fwd_tol)
    torch.testing.assert_close(lse, attention_lse_reference(q, k, H), atol=1e-4, rtol=1e-4)
    want = attention_backward_reference(q, k, v, do, H)
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == q.shape, name
        assert torch.equal(a, a2), f"{name}: two launches differ"
        torch.testing.assert_close(a.float(), b.float(), atol=bwd_tol, rtol=bwd_tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)],
                         ids=["float32", "bfloat16"])
def test_sliced_switch_runs_the_sliced_forward_at_head_256(cuda_device, dtype, tol):
    """``sliced=True`` runs the sliced forward at a head the one-pass wide
    kernel would take (the comparison the smoke run times), counted under
    the sliced family, within the forward's bar; at head 128 it raises."""
    q, k, v = qkv((2, 65, 256, 1), dtype, cuda_device, seed=7, n=3)
    before = dict(ac.LAUNCHES)
    out = ac.attention_forward(q, k, v, 1, sliced=True)
    torch.cuda.synchronize()
    assert ac.LAUNCHES == dict(before, attention_fwd_sliced=before["attention_fwd_sliced"] + 1)
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, 1).float(),
                               atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="sliced"):
        ac.attention_forward(q, k, v, 2, sliced=True)


def test_kernel_family_follows_the_dispatch():
    """The wrapper's family of a head size (the LAUNCHES key it counts under)
    is the one csrc/attention.cu dispatches it to: its kWideHead and
    kClusterHead are the wrapper's WIDE_HEAD and CLUSTER_HEAD, and the
    widest cluster is the portable 8 blocks."""
    from pathlib import Path
    src = (Path(ac.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    assert f"constexpr int kWideHead = {ac.WIDE_HEAD};" in src
    assert f"constexpr int kClusterHead = {ac.CLUSTER_HEAD};" in src
    assert ac.CLUSTER_HEAD // ac.WIDE_HEAD == 8
    heads = (17, 32, 64, 128, 129, 136, 192, 256, 257, 512, 768, 2048, 2049, 4096)
    assert [ac.kernel_family(hd) for hd in heads] == \
        ["", "", "", "", "_wide", "_wide", "_wide", "_wide", "_cluster", "_cluster", "_cluster",
         "_cluster", "_sliced", "_sliced"]
    assert set(ac.LAUNCHES) == {f"attention_{d}{f}" for d in ("fwd", "bwd")
                                for f in ("", "_wide", "_cluster", "_sliced")}


def test_sliced_backward_switch_and_cluster_occupancy_refuse_other_heads():
    """The backward's sliced switch takes heads above 128 only (on any
    device), and the cluster occupancy query only the cluster kernels'
    heads, before any library is loaded."""
    q, k, v, do = qkv((2, 17, 128, 1), torch.float32, "cpu", n=4)
    with pytest.raises(ValueError, match="sliced"):
        ac.attention_backward(q, k, v, do, 1, sliced=True)
    wide = ac.attention_backward(*qkv((1, 9, 512, 1), torch.float32, "cpu", n=4), 1,
                                 sliced=True)
    assert [tuple(g.shape) for g in wide] == [(1, 9, 512)] * 3
    for hd in (256, 2049):
        with pytest.raises(ValueError, match="cluster"):
            ac.cluster_occupancy(hd, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_cluster_kernels_repeat_bit_for_bit(cuda_device, dtype):
    """The cluster kernels at the ViT's sequence, head 512, over more than
    one wave of clusters: a second forward and a second backward on the same
    inputs give the same bits (no atomics; every rank sums the partials in
    one order), each call counted under the cluster family, and the card
    holds clusters of every cluster kernel."""
    shape = (16, 225, 512, 1)
    q, k, v, do = qkv(shape, dtype, cuda_device, seed=9, n=4)
    before = dict(ac.LAUNCHES)
    outs = [ac.attention_forward(q, k, v, 1, want_lse=True) for _ in range(2)]
    grads = [ac.attention_backward(q, k, v, do, 1, out=outs[0][0], lse=outs[0][1])
             for _ in range(2)]
    torch.cuda.synchronize()
    assert ac.LAUNCHES == dict(before, attention_fwd_cluster=before["attention_fwd_cluster"] + 2,
                               attention_bwd_cluster=before["attention_bwd_cluster"] + 2)
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert torch.equal(a, b)
    found = ac.cluster_occupancy(512, dtype)
    assert set(found) == {"fwd", "fwd_lse", "bwd_dq", "bwd_dkdv"} and min(found.values()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol", [(torch.float32, 1e-4, 2e-4),
                                                   (torch.bfloat16, 0.05, 0.02)],
                         ids=["float32", "bfloat16"])
def test_sliced_switch_runs_the_sliced_kernels_at_head_512(cuda_device, dtype, fwd_tol, bwd_tol):
    """``sliced=True`` runs the sliced forward and backward at a head the
    cluster kernels would take (the comparison the smoke run times), counted
    under the sliced family, within the bars of the cluster kernels."""
    q, k, v, do = qkv((2, 65, 512, 1), dtype, cuda_device, seed=10, n=4)
    before = dict(ac.LAUNCHES)
    out, lse = ac.attention_forward(q, k, v, 1, want_lse=True, sliced=True)
    grads = ac.attention_backward(q, k, v, do, 1, out=out, lse=lse, sliced=True)
    torch.cuda.synchronize()
    assert ac.LAUNCHES == dict(before, attention_fwd_sliced=before["attention_fwd_sliced"] + 1,
                               attention_bwd_sliced=before["attention_bwd_sliced"] + 1)
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, 1).float(),
                               atol=fwd_tol, rtol=fwd_tol)
    for name, a, b in zip(("dq", "dk", "dv"), grads,
                          attention_backward_reference(q, k, v, do, 1)):
        torch.testing.assert_close(a.float(), b.float(), atol=bwd_tol, rtol=bwd_tol, msg=name)


def test_kernel_library_keeps_nvcc_log_beside_the_build(tmp_path, monkeypatch):
    """A build keeps nvcc's log (ptxas's registers and spills) beside the
    library, and a later build of the same source and flags, which finds the
    library built, returns that log instead of compiling again. A stand-in
    nvcc on PATH writes the output file and a ptxas line."""
    from aerial_gym_simulator_tpu_torch.ops import _build
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
                    'echo "ptxas info    : Used 42 registers" >&2\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}:{__import__('os').environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.KernelLibrary("attention")
    first = lib.build()
    assert "Used 42 registers" in first and lib.path().exists()
    assert lib.path().with_suffix(".log").read_text() == first
    nvcc.write_text("#!/bin/sh\nexit 1\n")              # a second compile would fail
    assert lib.build() == first
    assert _build.build_all([lib]) == [first]


def _icosphere_stl(path, subdiv=2, radius=0.8):
    """A subdivided icosahedron written as a binary STL; returns its faces."""
    import struct
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdiv):
        mid, verts = {}, list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), nf
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(f)))
        for tri in f:
            fh.write(struct.pack("<3f", 0, 0, 0))
            for vi in tri:
                fh.write(struct.pack("<3f", *(v[vi] * radius)))
            fh.write(struct.pack("<H", 0))
    return len(f)


def _mesh_env(device, stl, n_envs=2):
    """env_with_obstacles with two assets of the STL, every triangle kept."""
    from aerial_gym_simulator_tpu_torch.config.asset_config import env_object_config as eoc
    from aerial_gym_simulator_tpu_torch.config.env_config.obstacle_envs import (
        EnvWithObstaclesConfig)
    from aerial_gym_simulator_tpu_torch.envs.scene import build_scene_params
    from aerial_gym_simulator_tpu_torch.registry.registries import (
        controller_registry, robot_registry, sim_config_registry)
    from aerial_gym_simulator_tpu_torch.sim.env_manager import EnvManager
    from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params
    urdf = (f'<robot name="blob"><link name="base_link"><collision><geometry>'
            f'<mesh filename="{stl}"/></geometry></collision></link></robot>')
    asset = eoc.AssetTypeConfig(name="blobs", num_assets=2, urdf_variants=[urdf],
                                min_state_ratio=eoc._ratio(0.35, 0.2, 0.3),
                                max_state_ratio=eoc._ratio(0.85, 0.8, 0.7), keep_in_env=True,
                                semantic_id=42)
    cfg = EnvWithObstaclesConfig()
    cfg.asset_types = list(cfg.asset_types) + [asset]
    cfg.__post_init__()
    scene = build_scene_params(cfg, n_envs, device, max_prims=512)
    robot = robot_registry.make("base_quadrotor_with_camera")
    params = build_sim_params(sim_config_registry.make("base_sim"), cfg, robot,
                              controller_registry.make("lee_velocity_control"), device,
                              num_envs=n_envs, scene=scene)
    return EnvManager(params, seed=1)


@pytest.mark.cuda
def test_mesh_scene_kernels_match_plain_version(cuda_device, tmp_path):
    """K1-K4 on a table of 640 triangles beside the obstacle env's
    primitives: bit-equal to the plain version, broad phase on and off."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    _icosphere_stl(str(tmp_path / "sphere.stl"))
    env = _mesh_env(cuda_device, tmp_path / "sphere.stl")
    env.step(torch.zeros((2, 4), device=cuda_device))
    st, sp, sc = env.state, env.params.camera, env.params.scene
    a = cast_inputs(env.params, st, sp, st.cam_mount_pos, st.cam_mount_quat)
    args, counts = a[:4], (a[4], a[5], a[6], 4.0)
    for want_seg in (False, True):
        k = rc.raycast(*args, *counts, n_tri=sc.n_tri, want_seg=want_seg)
        k_off = rc.raycast(*args, *counts, n_tri=sc.n_tri, want_seg=want_seg, cull=False)
        ref = rc.raycast_reference(*args, *counts, n_tri=sc.n_tri, want_seg=want_seg)
        torch.cuda.synchronize()
        for x, y, z in zip(k, k_off, ref):
            if z is not None:
                assert torch.equal(x, z) and torch.equal(y, z)
    _compare_modes(args, counts, sc.n_tri)


@pytest.mark.cuda
def test_stereo_render_launches_k2_and_k1_bit_equal(cuda_device):
    """A stereo capture: the left eye on K2, the right eye on K1, each
    bit-equal to the plain version, the image their range-limited max."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        apply_range_limits, cast_inputs, render_camera, right_eye_origin, sensor_world_pose)
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_stereo_camera",
                                      "lee_velocity_control", num_envs=2, seed=1)
    env.step(torch.zeros((2, 4), device=cuda_device))
    st, sp, sc = env.state, env.params.camera, env.params.scene
    before = dict(rc.LAUNCHES)
    depth, _ = render_camera(env.params, st)
    torch.cuda.synchronize()
    assert rc.LAUNCHES["raycast_seg"] == before["raycast_seg"] + 1
    assert rc.LAUNCHES["raycast_depth"] == before["raycast_depth"] + 1
    left = cast_inputs(env.params, st, sp, st.cam_mount_pos, st.cam_mount_quat)
    pos_w, quat_w = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    right = (rc.pack_pose(right_eye_origin(sp, pos_w, quat_w), quat_w),) + left[1:]
    d_l, s_l = rc.raycast(*left, n_tri=sc.n_tri)
    d_r, _ = rc.raycast(*right, n_tri=sc.n_tri, want_seg=False)
    r_l = rc.raycast_reference(*left, n_tri=sc.n_tri)
    r_r = rc.raycast_reference(*right, n_tri=sc.n_tri, want_seg=False)
    torch.cuda.synchronize()
    assert torch.equal(d_l, r_l[0]) and torch.equal(s_l, r_l[1]) and torch.equal(d_r, r_r[0])
    fused = apply_range_limits(sp, torch.maximum(d_l, d_r).reshape(depth.shape)) / sp.max_range
    assert torch.equal(fused, depth)


@pytest.mark.cuda
def test_raycast_depth_diff_forward_is_k1_and_gradients_finite(cuda_device):
    """ops/raycast_diff on CUDA tensors: the forward is K1 (one depth
    launch), bit-equal to raycast_reference on the same packed tables, and
    the oracle's backward gives finite pose gradients on a small obstacle
    scene."""
    from aerial_gym_simulator_tpu_torch.ops.raycast_diff import raycast_depth_diff
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                      "lee_velocity_control", num_envs=4, seed=7)
    env.reset()
    sc, st = env.params.scene, env.state
    dirs = torch.as_tensor(camera_ray_dirs(16, 32, 87.0)[0]).reshape(-1, 3).to(cuda_device)
    poses = [x.clone().requires_grad_(True)
             for x in (st.obstacle_pos, st.obstacle_quat, st.pos, st.quat)]
    before = rc.LAUNCHES["raycast_depth"]
    t = raycast_depth_diff(sc, *poses, dirs, 10.0)
    torch.cuda.synchronize()
    assert rc.LAUNCHES["raycast_depth"] == before + 1
    ones = torch.ones(dirs.shape[0], device=cuda_device)
    with torch.no_grad():
        ref, _ = rc.raycast_reference(rc.pack_pose(st.pos, st.quat),
                                      rc.pack_prims_world(sc, st.obstacle_pos, st.obstacle_quat),
                                      dirs, ones, sc.n_box, sc.n_cyl, sc.n_sph, 10.0,
                                      want_seg=False, n_tri=sc.n_tri)
    assert torch.equal(t.detach(), ref)
    hit = t < 1000.0
    assert hit.any()
    torch.sum(torch.where(hit, t, torch.zeros_like(t))).backward()
    for p in poses:
        assert torch.isfinite(p.grad).all()
    assert poses[0].grad.abs().max().item() > 0.0


@pytest.mark.cuda
def test_a_block_of_envs_steps_and_renders_as_in_the_whole_batch(cuda_device):
    """The draw rule's premise on the card: a 512-env block of the obstacle
    env, stepped and rendered on its own (generator told of the block, the
    scene's per-env tables cut to it), equals the same rows of the 1,024-env
    batch bit for bit. The two small products whose GEMM kernel, and so
    rounding, follows the row count run row by row (utils/math.rowwise_matmul)."""
    from aerial_gym_simulator_tpu_torch.parallel import mesh as meshlib
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import render_camera
    from aerial_gym_simulator_tpu_torch.sim import dynamics

    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")
    whole = port.SimBuilder().build_env(*names, num_envs=1024, seed=3)
    block = port.SimBuilder().build_env(*names, num_envs=1024, seed=3)
    shard = meshlib.EnvShard(1, 2, 512, 512, 1024)
    meshlib.shard_params_(block.params, shard)
    state = meshlib.shard_env_pytree(block.state, shard, 1024)
    meshlib.register_generators(state, shard)
    rows = slice(512, 1024)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    full_state = whole.state
    for _ in range(3):
        action = torch.rand((1024, 4), generator=g, device=cuda_device) * 2 - 1
        full_state = dynamics.env_step(whole.params, full_state, action)
        state = dynamics.env_step(block.params, state, action[rows])
    for name in ("pos", "quat", "linvel", "angvel", "motor_thrust"):
        assert torch.equal(getattr(full_state, name)[rows], getattr(state, name)), name
    d_whole, _ = render_camera(whole.params, full_state, want_seg=False)
    d_block, _ = render_camera(block.params, state, want_seg=False)
    assert torch.equal(d_whole[rows], d_block)
