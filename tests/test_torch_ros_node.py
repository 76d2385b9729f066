"""Port parity for the ROS deployment node over the loopback transport
(JAX tests/test_ros_node.py:30-90): the node's real Subscriber, Publisher,
Rate and spin code against an in-process rospy, at 20x real time.

The bus fixture restores ``sys.modules`` when it ends: ``install()`` writes
``rospy`` and the message modules there and drops both packages' node
modules, and a JAX test run later in the same worker must not find this
test's bus. Tolerance: the node's first command against the policy run
directly (the port's and the JAX package's) on the same observation, 1e-5.
Waits poll against a deadline.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.sim2real.sample_factory_inference import (
    RL_Nav_Interface as JNavInterface)

from aerial_gym_simulator_tpu_torch.sim2real import ros_loopback

CKPT = os.path.join(os.path.dirname(__file__), "..", "examples", "dce_rl_navigation",
                    "selected_network", "navigation_policy.npz")
ROS_MODULES = ("rospy", "geometry_msgs", "geometry_msgs.msg", "nav_msgs", "nav_msgs.msg",
               "aerial_gym_simulator_tpu_torch.sim2real.ros_node",
               "aerial_gym_simulator_tpu.sim2real.ros_node")
DEADLINE_S = 30.0


def _install(monkeypatch):
    """The loopback bus, with every sys.modules entry it touches recorded on
    ``monkeypatch`` so that its undo restores them."""
    for name in ROS_MODULES:
        if name in sys.modules:
            monkeypatch.setitem(sys.modules, name, sys.modules[name])
        else:                               # absent again after the undo
            monkeypatch.setitem(sys.modules, name, None)
            monkeypatch.delitem(sys.modules, name)
    return ros_loopback.install(rate_scale=20.0)      # 20x real time


@pytest.fixture()
def bus(monkeypatch):
    b = _install(monkeypatch)
    yield b
    b.shutdown.set()


def _node(**kw):
    from aerial_gym_simulator_tpu_torch.sim2real.ros_node import HAVE_ROS, NavPolicyNode
    assert HAVE_ROS, "the loopback transport must satisfy the node's ROS gate"
    return NavPolicyNode(CKPT, goal=(5.0, 0.0, 1.5), device="cpu", **kw)


def _command(msg):
    return np.array([msg.twist.linear.x, msg.twist.linear.y, msg.twist.linear.z,
                     msg.twist.angular.z])


def test_nav_policy_node_end_to_end(bus):
    """Odometry in, TwistStamped commands out at the node's rate."""
    node = _node()
    t = threading.Thread(target=node.spin, daemon=True)
    t.start()
    n_in = 20
    for k in range(n_in):
        bus.publish("odometry", ros_loopback.make_odometry(
            [0.05 * k, 0.0, 1.0], [0, 0, 0, 1], [0.5, 0, 0], [0, 0, 0]))
        deadline = time.time() + DEADLINE_S      # one command per odometry tick
        while len(bus.published.get("cmd_vel", [])) <= k and time.time() < deadline:
            time.sleep(0.002)
    bus.shutdown.set()
    t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "spin() must exit on shutdown"
    cmds = bus.published.get("cmd_vel", [])
    assert len(cmds) >= n_in, f"only {len(cmds)} commands for {n_in} odometry messages"
    acts = np.array([_command(m) for _, m in cmds])
    assert np.isfinite(acts).all()
    assert np.abs(np.diff(acts, axis=0)).sum() > 0, "commands must follow the odometry"


def test_nav_policy_node_first_command_matches_direct_policy(bus):
    """One odometry message: the first command equals the port's policy and
    the JAX package's run directly on the node's observation."""
    odom = ros_loopback.make_odometry([0.0, 0.0, 1.0], [0, 0, 0, 1], [0.5, 0, 0], [0, 0, 0])
    node = _node()
    t = threading.Thread(target=node.spin, daemon=True)
    t.start()
    bus.publish("odometry", odom)
    deadline = time.time() + DEADLINE_S
    while not bus.published.get("cmd_vel") and time.time() < deadline:
        time.sleep(0.002)
    bus.shutdown.set()
    t.join(timeout=DEADLINE_S)
    cmds = bus.published.get("cmd_vel", [])
    assert cmds, "the node never published"
    first = _command(cmds[0][1])

    ref = _node()
    ref._odom_cb(odom)
    obs = ref.build_obs()[None]
    direct = np.asarray(ref.policy.step({"observations": obs})[0])[:4]
    np.testing.assert_allclose(first, direct, atol=1e-5)
    j_direct = JNavInterface(num_envs=1, checkpoint_path=CKPT).step({"observations": obs})[0]
    np.testing.assert_allclose(first, j_direct[:4], atol=1e-5)


def test_bus_fixture_restores_sys_modules():
    """Inside, the loopback owns rospy and the node binds to it; after the
    undo every entry is what it was (or absent again), so a later test in
    the same process does not find this bus."""
    missing = object()
    before = {n: sys.modules.get(n, missing) for n in ROS_MODULES}
    mp = pytest.MonkeyPatch()
    try:
        b = _install(mp)
        assert getattr(sys.modules["rospy"], "__is_aerial_gym_loopback__", False)
        assert _node() is not None
        b.shutdown.set()
    finally:
        mp.undo()
    after = {n: sys.modules.get(n, missing) for n in ROS_MODULES}
    assert all(after[n] is before[n] for n in ROS_MODULES), \
        [n for n in ROS_MODULES if after[n] is not before[n]]


def test_quat_to_euler_matches_jax():
    from aerial_gym_simulator_tpu.sim2real.ros_node import quat_to_euler_zyx as j_euler

    from aerial_gym_simulator_tpu_torch.sim2real.ros_node import quat_to_euler_zyx
    rng = np.random.default_rng(0)
    for q in rng.normal(size=(20, 4)):
        q = q / np.linalg.norm(q)
        np.testing.assert_allclose(quat_to_euler_zyx(*q), j_euler(*q), atol=1e-12)
    assert quat_to_euler_zyx(0.0, np.sqrt(0.5), 0.0, np.sqrt(0.5))[1] == pytest.approx(np.pi / 2)


def test_node_without_ros_raises(monkeypatch):
    from aerial_gym_simulator_tpu_torch.sim2real import ros_node
    monkeypatch.setattr(ros_node, "HAVE_ROS", False)
    with pytest.raises(ImportError, match="rospy not available"):
        ros_node.NavPolicyNode(CKPT, device="cpu")


def test_node_policy_runs_on_cuda_unless_asked_for_the_cpu(bus):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from aerial_gym_simulator_tpu_torch.sim2real.ros_node import NavPolicyNode
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NavPolicyNode(CKPT)
