"""Port parity for the utilities: the twelve math helpers added to
utils/math.py, the mixing-matrix calculator, TensorPID, the command-line
helpers, the debug switches, the ROS tools (real_robot_sysid,
imu_to_rosbag) under stub ROS modules, and the robots re-export surface.

Tolerances: the math helpers atol/rtol 1e-6 on seeded numpy inputs (the
same f32 expressions), the hat/vee round trip 1e-6 (tests/test_math.py:72);
the mixing matrix and its report exactly equal to JAX's (the same float64
numpy arithmetic); TensorPID over JAX's 400-step plant atol 1e-5 (400
steps of f32 feedback); the ROS messages and every parsed value exact.
"""

import argparse
import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.utils import math as jm

from aerial_gym_simulator_tpu_torch.utils import math as tm

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=0, n=32):
    rs = np.random.RandomState(seed)
    q = rs.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rs.normal(size=(n, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    return dict(
        x=rs.uniform(-12.0, 12.0, (n, 3)).astype(np.float32),
        u=rs.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        lo=rs.uniform(-3.0, -1.0, (n, 3)).astype(np.float32),
        hi=rs.uniform(1.0, 4.0, (n, 3)).astype(np.float32),
        v=rs.normal(size=(n, 3)).astype(np.float32),
        t=rs.normal(size=(n, 3)).astype(np.float32),
        t2=rs.normal(size=(n, 3)).astype(np.float32),
        q=q, q2=q2,
        angle=rs.uniform(-4.0, 4.0, (n,)).astype(np.float32),
        axis=rs.normal(size=(n, 3)).astype(np.float32),
        mag=np.float32(rs.uniform(0.5, 2.0)), width=np.float32(rs.uniform(0.1, 2.0)),
        kp=rs.uniform(0.5, 3.0, (3,)).astype(np.float32),
        kd=rs.uniform(0.1, 1.0, (3,)).astype(np.float32),
    )


# name -> (argument names); each is called as f(*args) in both packages
HELPERS = {
    "normalize_angle": ("x",),
    "scale_transform": ("u", "lo", "hi"),
    "unscale_transform": ("x", "lo", "hi"),
    "exponential_reward": ("mag", "width", "v"),
    "exponential_penalty": ("mag", "width", "v"),
    "hat_map": ("v",),
    "pd_control": ("v", "t", "kp", "kd"),
    "quat_from_angle_axis": ("angle", "axis"),
    "tf_vector": ("q", "v"),
    "tf_inverse": ("q", "t"),
    "tf_combine": ("q", "t", "q2", "t2"),
    "get_basis_vector": ("q", "v"),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_math_helper_matches_jax(name):
    d = _inputs(seed=sorted(HELPERS).index(name))
    args = HELPERS[name]
    want = getattr(jm, name)(*[jnp.asarray(d[a]) for a in args])
    got = getattr(tm, name)(*[torch.as_tensor(d[a]) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_math_helpers_broadcast_over_leading_dims():
    """(2, 5, ...) inputs give the (2, 5, ...) results of the flat call."""
    d = _inputs(seed=3, n=10)
    q = torch.as_tensor(d["q"]).reshape(2, 5, 4)
    t = torch.as_tensor(d["t"]).reshape(2, 5, 3)
    qi, ti = tm.tf_inverse(q, t)
    qf, tf = tm.tf_inverse(q.reshape(10, 4), t.reshape(10, 3))
    assert torch.equal(qi.reshape(10, 4), qf) and torch.equal(ti.reshape(10, 3), tf)
    # a transform combined with its inverse is the identity
    qc, tc = tm.tf_combine(q, t, qi, ti)
    np.testing.assert_allclose(qc[..., 3].abs().numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-5)


def test_hat_map_vee_round_trip():
    v = torch.as_tensor(np.random.RandomState(8).randn(16, 3).astype(np.float32))
    np.testing.assert_allclose(tm.compute_vee_map(tm.hat_map(v)).numpy(), v.numpy(), **TOL)
    h = tm.hat_map(v)
    assert torch.equal(h, -h.transpose(-1, -2))
    np.testing.assert_allclose((h @ v[..., None])[..., 0].numpy(), 0.0, atol=1e-6)


# -- the mixing matrix ----------------------------------------------------------


def _mixing_cases():
    L = 0.2
    quad = dict(motor_positions=[[L, -L, 0], [-L, L, 0], [L, L, 0], [-L, -L, 0]],
                motor_directions=[-1, -1, 1, 1], thrust_to_torque_ratio=0.01)
    rng = np.random.default_rng(3)
    octo = dict(motor_positions=rng.uniform(-0.3, 0.3, (8, 3)), motor_axes=rng.normal(size=(8, 3)))
    return {"x_quad": quad, "tilted_octorotor": octo}


@pytest.mark.parametrize("case", sorted(_mixing_cases()))
def test_mixing_matrix_equals_jax(case):
    from aerial_gym_simulator_tpu.utils import calculate_mixing_matrix as jmix
    from aerial_gym_simulator_tpu_torch.utils import calculate_mixing_matrix as tmix

    kwargs = _mixing_cases()[case]
    want = jmix.calculate_mixing_matrix(**kwargs)
    got = tmix.calculate_mixing_matrix(**kwargs)
    np.testing.assert_array_equal(got, want)
    rep_t, rep_j = tmix.verify_mixing_matrix(got), jmix.verify_mixing_matrix(want)
    assert rep_t.keys() == rep_j.keys()
    for k in rep_j:
        np.testing.assert_array_equal(rep_t[k], rep_j[k], err_msg=k)
    if case == "x_quad":
        assert rep_t["rank"] == 4 and not rep_t["fully_actuated"]
        np.testing.assert_allclose(rep_t["hover_thrusts"], 0.25 * np.ones(4), atol=1e-9)
    else:
        assert rep_t["fully_actuated"]


# -- TensorPID ------------------------------------------------------------------


PID_KW = dict(num_envs=4, num_dims=2, Kp=2.0, Kd=0.1, Ki=0.5, dt=0.02,
              integral_min_limit=-1.0, integral_max_limit=1.0,
              derivative_saturation_min_limit=-10.0, derivative_saturation_max_limit=10.0,
              output_min_limit=-5.0, output_max_limit=5.0)


def test_tensor_pid_matches_jax_over_the_plant():
    """JAX tests/test_aux_utils.py:156-184's plant dx = u - 0.5x, 400
    steps from seeded starts and targets, then a masked reset."""
    from aerial_gym_simulator_tpu.utils.tensor_pid import TensorPID as JPID
    from aerial_gym_simulator_tpu_torch.utils.tensor_pid import PIDState, TensorPID

    rs = np.random.RandomState(5)
    x0 = rs.uniform(-0.5, 0.5, (4, 2)).astype(np.float32)
    target = rs.uniform(0.2, 1.2, (4, 2)).astype(np.float32)
    jp, tp = JPID(**PID_KW), TensorPID(**PID_KW, device="cpu")
    js, ts = jp.init_state(), tp.init_state()
    assert isinstance(ts, PIDState) and ts.integral.shape == (4, 2)
    jx, tx = jnp.asarray(x0), torch.as_tensor(x0)
    jt, tt = jnp.asarray(target), torch.as_tensor(target)
    outs_j, outs_t = [], []
    for _ in range(400):
        js, ju = jp.update(js, jt - jx)
        ts, tu = tp.update(ts, tt - tx)
        jx = jx + 0.02 * (ju - 0.5 * jx)
        tx = tx + 0.02 * (tu - 0.5 * tx)
        outs_j.append(np.asarray(ju))
        outs_t.append(tu.numpy())
    np.testing.assert_allclose(np.stack(outs_t), np.stack(outs_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.numpy(), target, atol=0.05)
    for f in PIDState._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    mask = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    js, ts = jp.reset_idx(js, jnp.asarray(mask)), tp.reset_idx(ts, torch.as_tensor(mask))
    for f in PIDState._fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    assert float(ts.integral[0].abs().sum()) == 0.0 and float(ts.integral[1].abs().sum()) != 0.0
    assert torch.equal(ts.just_reset[:, 0], torch.as_tensor(mask))
    # the D term is skipped right after a reset, in both packages
    err = jnp.ones((4, 2))
    _, ju = jp.update(jp.init_state(), err)
    _, tu = tp.update(tp.init_state(), torch.ones(4, 2))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)


def test_tensor_pid_needs_cuda_unless_asked_for_cpu():
    from aerial_gym_simulator_tpu_torch.utils.tensor_pid import TensorPID

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TensorPID(**PID_KW)


# -- the command-line helpers --------------------------------------------------


ARGVS = [
    [],
    ["--task", "navigation_task", "--num_envs", "64", "--seed", "7"],
    ["--headless", "--use_warp", "--robot_name", "lmf2", "--controller_name",
     "lee_velocity_control"],
    ["--sim_name", "base_sim_2ms", "--env_name", "forest_env", "--num_envs", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(x.strip("-") for x in a) or "none")
def test_helpers_match_jax_on_argv(argv):
    from aerial_gym_simulator_tpu.utils import helpers as jh
    from aerial_gym_simulator_tpu_torch.utils import helpers as th

    extras = (("--flag_x", dict(type=float, default=0.5)),)
    ja, ta = jh.get_args(argv, extras), th.get_args(argv, extras)
    assert vars(ta) == vars(ja)

    @dataclasses.dataclass
    class Cfg:
        seed: int = 1
        num_envs: int = 16
        headless: bool = False
        robot_name: str = "base_quadrotor"
        other: float = 2.0

    jc, tc = jh.update_task_config_from_args(Cfg(), ja), th.update_task_config_from_args(Cfg(), ta)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    if "--num_envs" in argv:
        assert tc.num_envs == int(argv[argv.index("--num_envs") + 1])
    else:
        assert tc.num_envs == 16          # only explicitly passed values win


def test_class_to_dict_matches_jax():
    from aerial_gym_simulator_tpu.utils import helpers as jh
    from aerial_gym_simulator_tpu_torch.config.robot_config.catalog import base_quadrotor
    from aerial_gym_simulator_tpu_torch.utils import helpers as th

    class Inner:
        def __init__(self):
            self.a, self._hidden, self.b = 1, 2, [3, (4, 5)]

    obj = argparse.Namespace(x={"k": Inner()}, y=(Inner(), 6), z="s")
    assert th.class_to_dict(obj) == jh.class_to_dict(obj)
    flat = th.class_to_dict(base_quadrotor())
    assert isinstance(flat, dict) and "control_allocator_config" in flat


# -- debug ----------------------------------------------------------------------


def test_debug_toggles_roundtrip():
    """JAX tests/test_misc_modules.py:102-113 on torch's switches."""
    from aerial_gym_simulator_tpu_torch.utils import debug

    try:
        debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - x.detach()).mul(0.0).div(torch.zeros(2)).sum().backward()
        debug.enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
        debug.enable_disable_jit(True)
        assert not torch.jit._state._enabled.enabled

        def plus_one(x):
            return x + 1

        assert torch.jit.script(plus_one) is plus_one      # left as Python
        debug.enable_disable_jit(False)
        assert torch.jit._state._enabled.enabled
    finally:
        debug.enable_nan_checks(False)
        debug.enable_disable_jit(False)


# -- the ROS tools under stub ROS modules -------------------------------------


class _Msg:
    """A ROS-message stand-in: nested fields appear on first access."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        v = _Msg()
        object.__setattr__(self, name, v)
        return v


def _plain(m):
    if isinstance(m, _Msg):
        return {k: _plain(v) for k, v in sorted(vars(m).items())}
    return m


def _stub_ros(monkeypatch):
    """rospy, rosbag, mavros_msgs.msg and sensor_msgs.msg stand-ins in
    sys.modules; -> the list rosbag.Bag writes into."""
    written = []

    class PositionTarget(_Msg):
        FRAME_BODY_NED = 8
        (IGNORE_PX, IGNORE_PY, IGNORE_PZ, IGNORE_VX, IGNORE_VY, IGNORE_VZ, IGNORE_AFX,
         IGNORE_AFY, IGNORE_AFZ, FORCE, IGNORE_YAW, IGNORE_YAW_RATE) = (1 << i for i in range(12))

    class Imu(_Msg):
        pass

    class Time:
        @staticmethod
        def now():
            return ("now",)

        @staticmethod
        def from_sec(t):
            return ("sec", t)

    class Bag:
        def __init__(self, path, mode):
            self.path, self.mode = path, mode

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def write(self, topic, msg, stamp):
            written.append((self.path, self.mode, topic, _plain(msg), stamp))

    mods = {"rospy": types.SimpleNamespace(Time=Time),
            "rosbag": types.SimpleNamespace(Bag=Bag),
            "mavros_msgs": types.ModuleType("mavros_msgs"),
            "mavros_msgs.msg": types.SimpleNamespace(PositionTarget=PositionTarget),
            "sensor_msgs": types.ModuleType("sensor_msgs"),
            "sensor_msgs.msg": types.SimpleNamespace(Imu=Imu)}
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return written


IMU_CSV = "t,ax,ay,az,gx,gy,gz\n0.0,0,0,9.81,0,0,0\n0.01,0.1,0,9.8,0,0,0.01\nbad,row\n2.5,1,2,3,4,5,6\n"


@pytest.mark.parametrize("mode", ["velocity", "acceleration"])
def test_build_position_target_matches_jax(monkeypatch, mode):
    from aerial_gym_simulator_tpu.utils import real_robot_sysid as jr
    from aerial_gym_simulator_tpu_torch.utils import real_robot_sysid as tr

    _stub_ros(monkeypatch)
    want = jr.build_position_target(mode, 1.5, -0.5, 0.25, 0.1)
    got = tr.build_position_target(mode, 1.5, -0.5, 0.25, 0.1)
    assert _plain(got) == _plain(want)
    assert got.type_mask == want.type_mask and got.coordinate_frame == 8


def test_imu_csv_tools_match_jax(monkeypatch, tmp_path):
    from aerial_gym_simulator_tpu.utils import imu_to_rosbag as ji
    from aerial_gym_simulator_tpu_torch.utils import imu_to_rosbag as ti

    path = tmp_path / "imu.csv"
    path.write_text(IMU_CSV)
    rows = list(ti.read_imu_csv(str(path)))
    assert rows == list(ji.read_imu_csv(str(path)))
    assert len(rows) == 3 and rows[1][0] == 0.01 and rows[0][3] == 9.81
    written = _stub_ros(monkeypatch)
    jm_msgs, tm_msgs = ji.csv_to_imu_msgs(str(path)), ti.csv_to_imu_msgs(str(path))
    assert [(t, _plain(m)) for t, m in tm_msgs] == [(t, _plain(m)) for t, m in jm_msgs]
    assert tm_msgs[2][1].header.stamp.secs == 2 and tm_msgs[2][1].header.stamp.nsecs == 5e8
    ji.write_bag(str(path), str(tmp_path / "j.bag"))
    ti.write_bag(str(path), str(tmp_path / "t.bag"))
    half = len(written) // 2
    assert half == 3
    assert [w[2:] for w in written[half:]] == [w[2:] for w in written[:half]]
    assert {w[0] for w in written[half:]} == {str(tmp_path / "t.bag")}


# -- robots -----------------------------------------------------------------------


def test_robots_exports_match_jax():
    from aerial_gym_simulator_tpu import robots as jr
    from aerial_gym_simulator_tpu_torch import robots as tr

    assert tr.__all__ == jr.__all__
    for name in tr.__all__:
        assert callable(getattr(tr, name)), name
    for name in ("base_quadrotor", "morphy", "base_rov"):
        t_cfg, j_cfg = getattr(tr, name)(), getattr(jr, name)()
        assert dataclasses.asdict(t_cfg.control_allocator_config) == \
            dataclasses.asdict(j_cfg.control_allocator_config), name
    assert tr.morphy_urdf() == jr.morphy_urdf()
    art = tr.parse_articulation(tr.snakey_urdf(4))
    assert isinstance(art, tr.ArticulationModel)
