"""Port parity: the ray cast's normal/face-id mode (K3) and RGB mode (K4)
in their plain versions (ops/raycast_cuda.raycast_reference), the port's
normal oracle and shade_rgb, against the JAX oracle
(ops/raycast.raycast_batched_normals + sensors/raycast_sensor.shade_rgb)
and the Pallas kernel in interpret mode, on the scenes of
tests/test_torch_raycast.py (3 envs, 8x128 rays) at a 4 m range, which
leaves hits and misses.

Tolerances: the JAX package's own bars for its Pallas kernel
(tests/test_raycast_pallas.py): depth atol 2e-3; face ids agree on more
than 99.5% of the rays and seg is equal where they do (a ray grazing an
edge or a depth tie may pick another primitive: the port packs world-frame
tables, the JAX oracle works in each asset's frame, ~1e-6 m apart);
normals atol 5e-3 where the face agrees and unit length within 1e-3;
misses exact; rgb atol 5e-3 on hits and 1e-6 on sky. shade_rgb on
identical inputs within 1e-6.

The kernel itself runs only on the card; tests/test_torch_kernels.py
holds it against these plain versions there.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.ops import raycast as j_oracle
from aerial_gym_simulator_tpu.ops import raycast_pallas as j_pallas
from aerial_gym_simulator_tpu.sensors.raycast_sensor import shade_rgb as j_shade_rgb
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder
from aerial_gym_simulator_tpu.utils.math import quat_rotate as j_quat_rotate

from aerial_gym_simulator_tpu_torch.ops import raycast as t_oracle
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.utils.math import quat_rotate


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MAX_RANGE = 4.0
DEPTH_ATOL = 2e-3
FACE_AGREE = 0.995
NORMAL_ATOL = 5e-3
RGB_ATOL = 5e-3
NO_HIT = j_oracle.NO_HIT_RAY_VAL


def _dirs(H=8, W=128):
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, H), np.linspace(-0.6, 0.6, W),
                         indexing="ij")
    d = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


DIRS = _dirs()
MULT = DIRS[:, 2].copy()       # a range -> depth multiplier, so the fade sees true depth

# one compiled JAX oracle per module: the scenes share their shapes
_j_normals = jax.jit(
    lambda sc, opos, oquat, pos, quat: j_oracle.raycast_batched_normals(
        sc, opos, oquat, pos, j_quat_rotate(quat[:, None, :], jnp.asarray(DIRS)[None]),
        MAX_RANGE))


@pytest.fixture(scope="module")
def jenv():
    env = JSimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                  "lee_velocity_control", num_envs=3, seed=7)
    env.reset()
    return env


SCENES = {
    "full_scene": {},
    "culled_obstacles": dict(park_half=True),
    "boundary_primitive": dict(shift=[0.0, -3.0, 0.0]),   # at the -y wall
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request, jenv):
    spec = SCENES[request.param]
    jp, js = jenv.params, jenv.state
    if "shift" in spec:
        js = js.replace(pos=js.pos + jnp.asarray(spec["shift"], jnp.float32))
    if spec.get("park_half"):
        A = js.obstacle_pos.shape[1]
        js = js.replace(obstacle_pos=js.obstacle_pos.at[:, A // 2:, :].set(-1000.0))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    sc = tp.scene
    t, s, n, f = (np.asarray(x) for x in _j_normals(jp.scene, js.obstacle_pos,
                                                      js.obstacle_quat, js.pos, js.quat))
    args = (rc.pack_pose(ts.pos, ts.quat),
            rc.pack_prims_world(sc, ts.obstacle_pos, ts.obstacle_quat),
            torch.from_numpy(DIRS))
    counts = (sc.n_box, sc.n_cyl, sc.n_sph, MAX_RANGE)
    return dict(name=request.param, jp=jp, js=js, tp=tp, ts=ts, args=args, counts=counts,
                n_tri=sc.n_tri, ref=dict(t=t, seg=s, normal=n, face=f))


def _normals(scene, mult=None, fn=rc.raycast):
    mult = torch.ones(DIRS.shape[0]) if mult is None else mult
    return fn(*scene["args"], mult, *scene["counts"], n_tri=scene["n_tri"], want_normals=True)


def _rgb(scene, fn=rc.raycast):
    return fn(*scene["args"], torch.from_numpy(MULT), *scene["counts"], n_tri=scene["n_tri"],
              want_rgb=True)


def _assert_normals_match(depth, seg, normal, face, ref):
    np.testing.assert_allclose(depth, ref["t"], atol=DEPTH_ATOL, rtol=0)
    hit = ref["face"] >= 0
    assert hit.any() and (~hit).any()
    same = face == ref["face"]
    assert same.mean() > FACE_AGREE
    assert (seg[hit & same] == ref["seg"][hit & same]).all()
    assert (face[~hit] == -1).all() and (seg[~hit] == -2).all()
    assert (normal[~hit] == 0.0).all() and (depth[~hit] == NO_HIT).all()
    np.testing.assert_allclose(normal[hit & same], ref["normal"][hit & same],
                               atol=NORMAL_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(normal[face >= 0], axis=-1), 1.0, atol=1e-3)


def _assert_rgb_match(depth, seg, rgb, depth_ref, seg_ref, rgb_ref, hit):
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(depth, depth_ref, atol=DEPTH_ATOL, rtol=0)
    assert (depth[~hit] == NO_HIT).all() and (seg[~hit] == -2).all()
    np.testing.assert_allclose(rgb[~hit], rgb_ref[~hit], atol=1e-6, rtol=0)
    same = seg == seg_ref
    assert same.mean() > FACE_AGREE
    np.testing.assert_allclose(rgb[hit & same], rgb_ref[hit & same], atol=RGB_ATOL, rtol=0)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0


def _jax_rgb(ref):
    depth = np.where(ref["face"] >= 0, ref["t"] * MULT[None, :], NO_HIT).astype(np.float32)
    rgb = j_shade_rgb(jnp.asarray(depth), jnp.asarray(ref["normal"]), jnp.asarray(ref["face"]),
                      jnp.asarray(ref["seg"]), MAX_RANGE)
    return depth, np.asarray(rgb)


def test_normal_mode_matches_jax_oracle(scene):
    out = [x.numpy() for x in _normals(scene)]
    _assert_normals_match(*out, scene["ref"])


def test_rgb_mode_matches_jax_oracle_shading(scene):
    depth, seg, rgb = (x.numpy() for x in _rgb(scene))
    depth_ref, rgb_ref = _jax_rgb(scene["ref"])
    _assert_rgb_match(depth, seg, rgb, depth_ref, scene["ref"]["seg"], rgb_ref,
                      scene["ref"]["face"] >= 0)


def test_port_oracle_normals_match_jax_oracle(scene):
    """ops/raycast.raycast_batched_normals (asset-frame formulation) vs JAX's."""
    ts = scene["ts"]
    rd = quat_rotate(ts.quat[:, None, :], torch.from_numpy(DIRS)[None])
    t, s, n, f = t_oracle.raycast_batched_normals(scene["tp"].scene, ts.obstacle_pos,
                                                  ts.obstacle_quat, ts.pos, rd, MAX_RANGE)
    _assert_normals_match(t.numpy(), s.numpy(), n.numpy(), f.numpy(), scene["ref"])


def test_modes_share_the_sweep(scene):
    """Depth and seg of the normal mode are the seg mode's, bit for bit; the
    RGB mode is the normal mode shaded by shade_rgb, bit for bit (what the
    CPU path of render_rgb computes)."""
    mult = torch.from_numpy(MULT)
    d2, s2 = rc.raycast(*scene["args"], mult, *scene["counts"], n_tri=scene["n_tri"])
    d3, s3, n3, f3 = _normals(scene, mult)
    assert torch.equal(d2, d3) and torch.equal(s2, s3)
    d4, s4, rgb4 = _rgb(scene)
    depth = torch.where(f3 >= 0, d3, torch.full_like(d3, NO_HIT))
    assert torch.equal(d4, depth) and torch.equal(s4, s3)
    assert torch.equal(rgb4, t_oracle.shade_rgb(depth, n3, f3, s3, MAX_RANGE))


@pytest.mark.parametrize("mode", ["normals", "rgb"])
def test_modes_match_pallas_interpret(jenv, mode):
    jp, js = jenv.params, jenv.state
    sc = jp.scene
    prims = j_pallas.pack_prims_world(sc, js.obstacle_pos, js.obstacle_quat)
    mult = jnp.ones(DIRS.shape[0]) if mode == "normals" else jnp.asarray(MULT)
    pal = [np.asarray(x) for x in j_pallas.raycast_pallas(
        j_pallas.pack_pose(js.pos, js.quat), prims, jnp.asarray(DIRS), mult, sc.n_box,
        sc.n_cyl, sc.n_sph, MAX_RANGE, n_tri=sc.n_tri, interpret=True,
        want_normals=mode == "normals", want_rgb=mode == "rgb")]
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    tsc = params_from_numpy(record_to_numpy(jp), "cpu").scene
    port = dict(args=(rc.pack_pose(ts.pos, ts.quat),
                      rc.pack_prims_world(tsc, ts.obstacle_pos, ts.obstacle_quat),
                      torch.from_numpy(DIRS)),
                counts=(tsc.n_box, tsc.n_cyl, tsc.n_sph, MAX_RANGE), n_tri=tsc.n_tri)
    if mode == "normals":
        t_pal, s_pal, n_pal, f_pal = pal
        ref = dict(t=t_pal, seg=s_pal, normal=n_pal, face=f_pal)
        _assert_normals_match(*(x.numpy() for x in _normals(port)), ref)
    else:
        depth, seg, rgb = (x.numpy() for x in _rgb(port))
        d_pal, s_pal, rgb_pal = pal
        _assert_rgb_match(depth, seg, rgb, d_pal, s_pal, rgb_pal, s_pal != -2)


def test_normals_all_kinds_synthetic():
    """One primitive of each kind (box, cylinder, sphere, triangle) at known
    poses: the plain normal mode and the port's oracle vs the JAX oracle and
    the analytic normals (tests/test_raycast_pallas.py)."""
    size = np.array([[1.0, 1.0, 1.0], [0.5, 2.0, 0.0], [0.7, 0.0, 0.0], [2.0, 0.0, 2.0]],
                    np.float32)
    pos = np.array([[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [-4.0, 0.0, 0.0], [-1.0, -4.0, 0.0]],
                   np.float32)
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    kind, sem, slot = (np.array([0, 1, 2, 3], np.int32), np.array([1, 2, 3, 4], np.int32),
                       np.zeros(4, np.int32))
    ro = np.array([0.0, 0.0, 0.2], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, -1.0, -0.05]],
                 np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a_pos, a_quat = np.zeros((1, 3), np.float32), np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    j_out = [np.asarray(x) for x in j_oracle.raycast_env_normals(
        *(jnp.asarray(x) for x in (kind, size, pos, rot, sem, slot, a_pos, a_quat, ro, d)),
        50.0)]
    tt = lambda x: torch.from_numpy(x)
    t_out = [x.numpy() for x in t_oracle.raycast_env_normals(
        *(tt(x) for x in (kind, size, pos, rot, sem, slot.astype(np.int64), a_pos, a_quat,
                          ro, d)), 50.0)]
    scene = SimpleNamespace(env_prim_slot=tt(slot.astype(np.int64))[None],
                            env_prim_size=tt(size)[None], env_prim_pos=tt(pos)[None],
                            env_prim_rot=tt(rot)[None], env_prim_semantic=tt(sem)[None])
    prims = rc.pack_prims_world(scene, tt(a_pos)[None], tt(a_quat)[None])
    pose = rc.pack_pose(tt(ro)[None], torch.tensor([[0.0, 0.0, 0.0, 1.0]]))
    d_k, s_k, n_k, f_k = (x[0].numpy() for x in rc.raycast(
        pose, prims, tt(d), torch.ones(4), 1, 1, 1, 50.0, n_tri=1, want_normals=True))
    zr = 0.2 / 0.7
    analytic = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [np.sqrt(1 - zr * zr), 0.0, zr],
                         [0.0, 0.0, 1.0]], np.float32)
    for t, s, n, f in (t_out, (d_k, s_k, n_k, f_k)):
        np.testing.assert_array_equal(f, j_out[3])
        np.testing.assert_array_equal(f, [0, 1, 2, 3])
        np.testing.assert_array_equal(s, sem)
        np.testing.assert_allclose(t, j_out[0], atol=DEPTH_ATOL)
        np.testing.assert_allclose(n, j_out[2], atol=NORMAL_ATOL)
        np.testing.assert_allclose(n, analytic, atol=1e-3)


def test_shade_rgb_matches_jax():
    rs = np.random.RandomState(0)
    shape = (3, 5, 7)
    n = rs.standard_normal(shape + (3,)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = rs.uniform(0.0, 6.0, shape).astype(np.float32)
    face = rs.randint(-1, 40, shape).astype(np.int32)
    seg = np.where(face >= 0, rs.randint(0, 60, shape), -2).astype(np.int32)
    want = np.asarray(j_shade_rgb(*(jnp.asarray(x) for x in (depth, n, face, seg)), 4.0))
    got = t_oracle.shade_rgb(*(torch.from_numpy(x) for x in (depth, n, face, seg)), 4.0)
    assert got.shape == shape + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[face < 0], np.broadcast_to(
        t_oracle.SKY_RGB, got.numpy()[face < 0].shape))


def test_shading_constants_match_jax():
    for name in ("SEG_ALBEDO", "SUN_DIR", "SKY_RGB"):
        np.testing.assert_array_equal(getattr(t_oracle, name), getattr(j_oracle, name), name)
    assert t_oracle.RGB_AMBIENT == j_oracle.RGB_AMBIENT
    np.testing.assert_array_equal(rc.SHADING[:30], j_oracle.SEG_ALBEDO.reshape(-1))
