"""CSV -> rosbag IMU converter (reference utils/imu_to_rosbag.py).

Counterpart of ``aerial_gym_simulator_tpu/utils/imu_to_rosbag.py``: turns
logged IMU CSV rows (``t, ax, ay, az, gx, gy, gz``), as
``examples.imu_data_collection`` writes them, into a ROS bag of
``sensor_msgs/Imu`` messages for offline tooling. ``rosbag`` and the ROS
message packages are imported inside the functions only; everything else
in the package stays ROS-free.

Usage:  python -m aerial_gym_simulator_tpu_torch.utils.imu_to_rosbag in.csv out.bag
"""

from __future__ import annotations

import csv
import logging
import sys

logger = logging.getLogger("imu_to_rosbag")


def read_imu_csv(csv_file: str):
    """Yield (t, ax, ay, az, gx, gy, gz) float rows, skipping headers."""
    with open(csv_file) as f:
        for row in csv.reader(f):
            try:
                yield tuple(float(v) for v in row[:7])
            except (ValueError, IndexError):
                continue


def csv_to_imu_msgs(csv_file: str, frame_id: str = "imu_link"):
    """Build sensor_msgs/Imu messages from the CSV (needs ROS installed)."""
    from sensor_msgs.msg import Imu  # gated: ROS runtime only

    msgs = []
    for t, ax, ay, az, gx, gy, gz in read_imu_csv(csv_file):
        m = Imu()
        m.header.stamp.secs = int(t)
        m.header.stamp.nsecs = int((t % 1.0) * 1e9)
        m.header.frame_id = frame_id
        m.linear_acceleration.x = ax
        m.linear_acceleration.y = ay
        m.linear_acceleration.z = az
        m.angular_velocity.x = gx
        m.angular_velocity.y = gy
        m.angular_velocity.z = gz
        msgs.append((t, m))
    return msgs


def write_bag(csv_file: str, bag_file: str, topic: str = "/imu/data"):
    import rosbag  # gated: ROS runtime only
    import rospy

    msgs = csv_to_imu_msgs(csv_file)
    with rosbag.Bag(bag_file, "w") as bag:
        for t, m in msgs:
            bag.write(topic, m, rospy.Time.from_sec(t))
    logger.info(f"wrote {len(msgs)} Imu messages to {bag_file}")


def main():  # pragma: no cover - requires ROS
    if len(sys.argv) != 3:
        print(__doc__)
        raise SystemExit(1)
    write_bag(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
