"""ROS deployment node.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/ros_node.py`` (after the
reference's ``sim2real/sample_factory_ros_node.py``): odometry -> the
navigation observation -> the policy (``RL_Nav_Interface``, on CUDA unless
``device="cpu"``) -> a velocity command. rospy is optional: the module
imports without it and raises only when a node is built. The observation
follows the navigation task's layout (unit vector to the goal, distance,
roll and pitch, body velocities, previous action, perception latents).
``ros_loopback.install()`` supplies an in-process rospy.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np

from .sample_factory_inference import RL_Nav_Interface

logger = logging.getLogger("sim2real_ros_node")

try:  # an optional dependency
    import rospy
    from geometry_msgs.msg import TwistStamped
    from nav_msgs.msg import Odometry
    HAVE_ROS = True
except Exception:
    HAVE_ROS = False


def quat_to_euler_zyx(qx, qy, qz, qw):
    """xyzw quaternion -> (roll, pitch, yaw)."""
    sinr = 2.0 * (qw * qx + qy * qz)
    cosr = 1.0 - 2.0 * (qx * qx + qy * qy)
    roll = math.atan2(sinr, cosr)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = math.copysign(math.pi / 2, sinp) if abs(sinp) >= 1 else math.asin(sinp)
    siny = 2.0 * (qw * qz + qx * qy)
    cosy = 1.0 - 2.0 * (qy * qy + qz * qz)
    yaw = math.atan2(siny, cosy)
    return roll, pitch, yaw


class NavPolicyNode:
    """Odometry-in, velocity-command-out navigation policy node."""

    def __init__(self, checkpoint_path: str, goal=(5.0, 0.0, 1.5), latent_dim: int = 64,
                 rate_hz: float = 10.0, device=None):
        if not HAVE_ROS:
            raise ImportError("rospy not available: run inside a ROS environment, install "
                              "sim2real.ros_loopback, or use Sim2RealInferenceClass with your "
                              "own transport")
        self.policy = RL_Nav_Interface(num_envs=1, checkpoint_path=checkpoint_path,
                                       device=device)
        self.goal = np.asarray(goal, np.float32)
        self.latents = np.zeros((latent_dim,), np.float32)
        self.prev_action = np.zeros((4,), np.float32)
        self.rate_hz = rate_hz
        self.odom: Optional[np.ndarray] = None

        rospy.init_node("aerial_gym_tpu_nav_policy")
        rospy.Subscriber("odometry", Odometry, self._odom_cb, queue_size=1)
        self.cmd_pub = rospy.Publisher("cmd_vel", TwistStamped, queue_size=1)

    def _odom_cb(self, msg):
        p = msg.pose.pose.position
        q = msg.pose.pose.orientation
        v = msg.twist.twist.linear
        w = msg.twist.twist.angular
        self.odom = np.array([p.x, p.y, p.z, q.x, q.y, q.z, q.w,
                              v.x, v.y, v.z, w.x, w.y, w.z], np.float32)

    def set_latents(self, latents: np.ndarray):
        """Feed perception latents from the onboard depth encoder."""
        self.latents = np.asarray(latents, np.float32)

    def build_obs(self) -> np.ndarray:
        o = self.odom
        pos, quat = o[0:3], o[3:7]
        linvel_b, angvel_b = o[7:10], o[10:13]
        vec = self.goal - pos
        dist = float(np.linalg.norm(vec))
        unit = vec / max(dist, 1e-6)
        roll, pitch, _ = quat_to_euler_zyx(*quat)
        state = np.concatenate([unit, [dist, roll, pitch, 0.0], linvel_b, angvel_b,
                                self.prev_action])
        return np.concatenate([state, self.latents]).astype(np.float32)

    def spin(self):
        rate = rospy.Rate(self.rate_hz)
        while not rospy.is_shutdown():
            if self.odom is not None:
                obs = self.build_obs()
                action = np.asarray(self.policy.step({"observations": obs[None]})[0])
                if action.shape[0] < 4:   # [vx, vz, yaw_rate]-style policies
                    action = np.concatenate([action, np.zeros(4 - action.shape[0])])
                self.prev_action = action[:4]
                msg = TwistStamped()
                msg.header.stamp = rospy.Time.now()
                msg.twist.linear.x = float(action[0])
                msg.twist.linear.y = float(action[1])
                msg.twist.linear.z = float(action[2])
                msg.twist.angular.z = float(action[3])
                self.cmd_pub.publish(msg)
            rate.sleep()


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.sim2real.ros_node
    --checkpoint P [--goal X Y Z] [--cpu]`` inside a ROS environment."""
    import argparse
    p = argparse.ArgumentParser(prog="python -m aerial_gym_simulator_tpu_torch.sim2real.ros_node")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--goal", nargs=3, type=float, default=[5.0, 0.0, 1.5])
    p.add_argument("--cpu", action="store_true",
                   help="run the policy on the CPU (the default is CUDA, which must be available)")
    args = p.parse_args(argv)
    NavPolicyNode(args.checkpoint, goal=args.goal, device="cpu" if args.cpu else None).spin()


if __name__ == "__main__":
    main()
