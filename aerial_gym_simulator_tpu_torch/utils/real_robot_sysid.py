"""Real-robot sys-id command node (reference utils/real_robot_sysid.py).

Counterpart of ``aerial_gym_simulator_tpu/utils/real_robot_sysid.py``:
publishes mavros ``PositionTarget`` step commands (velocity or acceleration
mode, body-NED frame) so the real vehicle's response can be logged and
compared against the simulator's dynamics. It is the flight-side half of
the sys-id workflow; the simulator side is ``examples.sys_id`` and
``examples.imu_data_collection``. rospy and the mavros messages are
imported inside the functions, so nothing else needs ROS.

Usage:  python -m aerial_gym_simulator_tpu_torch.utils.real_robot_sysid \
            [--mode velocity|acceleration] [--step 1.0] [--period 4.0]
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger("real_robot_sysid")


def build_position_target(mode: str, x: float, y: float, z: float,
                          yaw_rate: float):
    """mavros PositionTarget with the ignore-mask for the chosen mode."""
    from mavros_msgs.msg import PositionTarget  # gated: ROS runtime only
    import rospy

    msg = PositionTarget()
    msg.header.stamp = rospy.Time.now()
    msg.coordinate_frame = PositionTarget.FRAME_BODY_NED
    ignore_pos = (PositionTarget.IGNORE_PX | PositionTarget.IGNORE_PY
                  | PositionTarget.IGNORE_PZ)
    if mode == "velocity":
        msg.type_mask = (ignore_pos | PositionTarget.IGNORE_AFX
                         | PositionTarget.IGNORE_AFY
                         | PositionTarget.IGNORE_AFZ
                         | PositionTarget.IGNORE_YAW)
        msg.velocity.x, msg.velocity.y, msg.velocity.z = x, y, z
    else:  # acceleration
        msg.type_mask = (ignore_pos | PositionTarget.IGNORE_VX
                         | PositionTarget.IGNORE_VY
                         | PositionTarget.IGNORE_VZ
                         | PositionTarget.IGNORE_YAW)
        msg.acceleration_or_force.x = x
        msg.acceleration_or_force.y = y
        msg.acceleration_or_force.z = z
    msg.yaw_rate = yaw_rate
    return msg


def main():  # pragma: no cover - requires ROS + mavros
    import rospy
    from mavros_msgs.msg import PositionTarget

    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["velocity", "acceleration"],
                   default="velocity")
    p.add_argument("--step", type=float, default=1.0,
                   help="step command magnitude (x axis)")
    p.add_argument("--period", type=float, default=4.0,
                   help="seconds per on/off half-cycle")
    p.add_argument("--rate", type=float, default=20.0)
    args = p.parse_args()

    rospy.init_node("position_target_command_node")
    pub = rospy.Publisher("/mavros/setpoint_raw/local", PositionTarget,
                          queue_size=10)
    rate = rospy.Rate(args.rate)
    t0 = rospy.Time.now().to_sec()
    logger.info(f"publishing {args.mode} step commands "
                f"(±{args.step}, period {args.period}s)")
    while not rospy.is_shutdown():
        t = rospy.Time.now().to_sec() - t0
        on = int(t / args.period) % 2 == 0
        cmd = args.step if on else 0.0
        pub.publish(build_position_target(args.mode, cmd, 0.0, 0.0, 0.0))
        rate.sleep()


if __name__ == "__main__":
    main()
