"""In-process rospy-compatible loopback transport for the deployment node.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/ros_loopback.py`` (a
copy). No ROS distribution ships everywhere, but the deployment node
(``ros_node.NavPolicyNode``) is real code that should run, not only import.
This module provides the rospy surface that node touches (init_node,
Subscriber, Publisher, Rate, is_shutdown, Time, and the message types
nav_msgs Odometry and geometry_msgs TwistStamped) over an in-process topic
bus, so the node runs unmodified end to end: odometry in, policy actions
out, at a wall-clock rate (``rate_scale`` > 1 runs faster than real time).

It doubles as a rehearsal tool: dry-run a checkpoint and a node
configuration on a workstation before going near a robot. On a robot the
genuine rospy wins: ``install()`` refuses to shadow a real rospy.

``install()`` writes ``rospy`` and the message modules into
``sys.modules`` and drops every imported module whose name ends in
``sim2real.ros_node``, so that the node is imported anew against the bus.
A caller that must leave ``sys.modules`` as it found it (a test) restores
those entries itself.

Reference analog: ``sim2real/sample_factory_ros_node.py`` ran against a
live roscore on the real LMF2 platform.
"""

from __future__ import annotations

import sys
import threading
import time
import types
from typing import Callable, Dict, List


class _Vec3:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = x, y, z


class _Quat:
    def __init__(self, x=0.0, y=0.0, z=0.0, w=1.0):
        self.x, self.y, self.z, self.w = x, y, z, w


class _Header:
    def __init__(self):
        self.stamp = 0.0
        self.frame_id = ""


class _PoseWrap:
    def __init__(self):
        self.pose = types.SimpleNamespace(position=_Vec3(),
                                          orientation=_Quat())


class _TwistWrap:
    def __init__(self):
        self.twist = types.SimpleNamespace(linear=_Vec3(), angular=_Vec3())


class Odometry:
    """nav_msgs/Odometry with the nested attribute paths the nodes read."""

    def __init__(self):
        self.header = _Header()
        self.pose = _PoseWrap()
        self.twist = _TwistWrap()


class TwistStamped:
    """geometry_msgs/TwistStamped as published by the nodes."""

    def __init__(self):
        self.header = _Header()
        self.twist = types.SimpleNamespace(linear=_Vec3(), angular=_Vec3())


class LoopbackBus:
    """Topic bus: subscribers get callbacks synchronously on publish."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self.published: Dict[str, List] = {}
        self.shutdown = threading.Event()
        self.rate_scale = 1.0          # >1 = faster-than-realtime rehearsal
        self.lock = threading.Lock()

    def subscribe(self, topic: str, cb: Callable):
        with self.lock:
            self._subs.setdefault(topic, []).append(cb)

    def publish(self, topic: str, msg):
        with self.lock:
            self.published.setdefault(topic, []).append((time.time(), msg))
            cbs = list(self._subs.get(topic, []))
        for cb in cbs:
            cb(msg)


def _make_rospy(bus: LoopbackBus):
    rospy = types.ModuleType("rospy")
    rospy.__is_aerial_gym_loopback__ = True

    def init_node(name, **kw):
        rospy._node_name = name

    class Subscriber:
        def __init__(self, topic, msg_type, callback, queue_size=1):
            bus.subscribe(topic, callback)

    class Publisher:
        def __init__(self, topic, msg_type, queue_size=1):
            self.topic = topic

        def publish(self, msg):
            bus.publish(self.topic, msg)

    class Rate:
        def __init__(self, hz):
            self.period = 1.0 / (float(hz) * bus.rate_scale)
            self._next = time.time()

        def sleep(self):
            self._next += self.period
            dt = self._next - time.time()
            if dt > 0:
                time.sleep(dt)

    class Time:
        @staticmethod
        def now():
            return time.time()

    rospy.init_node = init_node
    rospy.Subscriber = Subscriber
    rospy.Publisher = Publisher
    rospy.Rate = Rate
    rospy.Time = Time
    rospy.is_shutdown = bus.shutdown.is_set
    rospy.signal_shutdown = lambda reason="": bus.shutdown.set()
    return rospy


def install(rate_scale: float = 1.0) -> LoopbackBus:
    """Install the loopback transport into sys.modules (only when the real
    rospy is absent) and return the bus. Re-imports of the node modules
    then bind to the loopback. Returns the bus for driving/inspection."""
    try:
        import rospy as real_rospy
        if not getattr(real_rospy, "__is_aerial_gym_loopback__", False):
            raise RuntimeError(
                "a real rospy is installed — use the genuine ROS transport")
    except ImportError:
        pass

    bus = LoopbackBus()
    bus.rate_scale = rate_scale
    rospy = _make_rospy(bus)

    geom = types.ModuleType("geometry_msgs")
    geom_msg = types.ModuleType("geometry_msgs.msg")
    geom_msg.TwistStamped = TwistStamped
    geom.msg = geom_msg
    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")
    nav_msg.Odometry = Odometry
    nav.msg = nav_msg

    sys.modules["rospy"] = rospy
    sys.modules["geometry_msgs"] = geom
    sys.modules["geometry_msgs.msg"] = geom_msg
    sys.modules["nav_msgs"] = nav
    sys.modules["nav_msgs.msg"] = nav_msg

    # the node modules bind HAVE_ROS at import: re-import them fresh
    for name in list(sys.modules):
        if name.endswith("sim2real.ros_node"):
            del sys.modules[name]
    return bus


def make_odometry(pos, quat, linvel, angvel) -> Odometry:
    """Fill an Odometry message from plain arrays."""
    msg = Odometry()
    p, q = msg.pose.pose.position, msg.pose.pose.orientation
    p.x, p.y, p.z = map(float, pos)
    q.x, q.y, q.z, q.w = map(float, quat)
    v, w = msg.twist.twist.linear, msg.twist.twist.angular
    v.x, v.y, v.z = map(float, linvel)
    w.x, w.y, w.z = map(float, angvel)
    msg.header.stamp = time.time()
    return msg
