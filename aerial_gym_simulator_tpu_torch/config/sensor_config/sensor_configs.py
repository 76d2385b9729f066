"""Sensor configs, copied from the JAX package's
``config/sensor_config/sensor_configs.py`` and cut to the base depth
camera, the normal/face-id camera, the base lidar, the Robosense Airy
dome lidar and the fake radar."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SensorNoiseConfig:
    enable_sensor_noise: bool = False
    std_a: float = 0.00001
    std_b: float = 0.00001
    std_c: float = 0.00001
    mean_offset: float = 0.0
    pixel_dropout_prob: float = 0.01


@dataclass
class BaseDepthCameraConfig:
    num_sensors: int = 1
    sensor_type: str = "camera"
    height: int = 135
    width: int = 240
    horizontal_fov_deg: float = 87.000
    max_range: float = 10.0
    min_range: float = 0.2
    calculate_depth: bool = True
    return_pointcloud: bool = False
    pointcloud_in_world_frame: bool = False
    segmentation_camera: bool = True
    euler_frame_rot_deg: List[float] = field(default_factory=lambda: [-90.0, 0.0, -90.0])
    normalize_range: bool = True
    randomize_placement: bool = True
    min_translation: List[float] = field(default_factory=lambda: [0.07, -0.06, 0.01])
    max_translation: List[float] = field(default_factory=lambda: [0.12, 0.03, 0.04])
    min_euler_rotation_deg: List[float] = field(default_factory=lambda: [-5.0, -5.0, -5.0])
    max_euler_rotation_deg: List[float] = field(default_factory=lambda: [5.0, 5.0, 5.0])
    nominal_position: List[float] = field(default_factory=lambda: [0.10, 0.0, 0.03])
    nominal_orientation_euler_deg: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    sensor_noise: SensorNoiseConfig = field(default_factory=SensorNoiseConfig)
    stereo_baseline: float = 0.0

    @property
    def far_out_of_range_value(self) -> float:
        return self.max_range if self.normalize_range else -1.0

    @property
    def near_out_of_range_value(self) -> float:
        return -self.max_range if self.normalize_range else -1.0


@dataclass
class BaseNormalFaceIDCameraConfig(BaseDepthCameraConfig):
    """Returns surface normals + face (primitive) ids for dataset generation;
    its depth is range (multiplier 1)."""
    segmentation_camera: bool = True
    calculate_depth: bool = False


@dataclass
class BaseLidarConfig:
    num_sensors: int = 1
    sensor_type: str = "lidar"
    height: int = 128                  # scan lines
    width: int = 512                   # points per line
    horizontal_fov_deg_min: float = -180.0
    horizontal_fov_deg_max: float = 180.0
    vertical_fov_deg_min: float = -45.0
    vertical_fov_deg_max: float = 45.0
    max_range: float = 10.0
    min_range: float = 0.2
    calculate_depth: bool = False      # lidar returns range, not depth
    return_pointcloud: bool = False
    pointcloud_in_world_frame: bool = False
    segmentation_camera: bool = True
    euler_frame_rot_deg: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    normalize_range: bool = True
    randomize_placement: bool = True
    min_translation: List[float] = field(default_factory=lambda: [0.07, -0.06, 0.01])
    max_translation: List[float] = field(default_factory=lambda: [0.12, 0.03, 0.04])
    min_euler_rotation_deg: List[float] = field(default_factory=lambda: [-5.0, -5.0, -5.0])
    max_euler_rotation_deg: List[float] = field(default_factory=lambda: [5.0, 5.0, 5.0])
    nominal_position: List[float] = field(default_factory=lambda: [0.10, 0.0, 0.03])
    nominal_orientation_euler_deg: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=True, std_a=1e-5, std_b=1e-5, std_c=1e-5,
            mean_offset=-0.05, pixel_dropout_prob=0.0))
    stereo_baseline: float = 0.0
    # out-of-range sentinels; None derives them from normalize_range and
    # max_range (a subclass may pin the reference's inherited values)
    far_out_of_range_value: Optional[float] = None
    near_out_of_range_value: Optional[float] = None

    def __post_init__(self):
        if self.far_out_of_range_value is None:
            self.far_out_of_range_value = self.max_range if self.normalize_range else -1.0
        if self.near_out_of_range_value is None:
            self.near_out_of_range_value = -self.max_range if self.normalize_range else -1.0


@dataclass
class RSLidarAiryConfig(BaseLidarConfig):
    """Robosense Airy dome lidar: a 48x120 world-frame pointcloud (the
    magpie robot's sensor in the lidar navigation task)."""
    height: int = 48
    width: int = 120
    horizontal_fov_deg_min: float = -180.0
    horizontal_fov_deg_max: float = 180.0
    vertical_fov_deg_min: float = 0.0
    vertical_fov_deg_max: float = 90.0
    max_range: float = 10.0
    min_range: float = 0.2
    return_pointcloud: bool = True
    pointcloud_in_world_frame: bool = True
    segmentation_camera: bool = False
    normalize_range: bool = False
    # a fixed mount: 5 cm back, pitched -90 degrees (looking up through the dome)
    min_translation: List[float] = field(default_factory=lambda: [-0.05, 0.0, 0.0])
    max_translation: List[float] = field(default_factory=lambda: [-0.05, 0.0, 0.0])
    min_euler_rotation_deg: List[float] = field(default_factory=lambda: [0.0, -90.0, 0.0])
    max_euler_rotation_deg: List[float] = field(default_factory=lambda: [0.0, -90.0, 0.0])
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=0.00038089,
            std_b=-0.00343351, std_c=0.01553284,
            mean_offset=-0.025, pixel_dropout_prob=0.0))
    # the base lidar's sentinels, pinned: the source never recomputes them
    # for the world-frame pointcloud
    far_out_of_range_value: Optional[float] = 10.0
    near_out_of_range_value: Optional[float] = -10.0


@dataclass
class FakeRadarConfig(BaseLidarConfig):
    """A radar cone rendered like a lidar: 48x120 rays over +-60 degrees,
    a world-frame pointcloud (the radar navigation task's sensor)."""
    height: int = 48
    width: int = 120
    horizontal_fov_deg_min: float = -60.0
    horizontal_fov_deg_max: float = 60.0
    vertical_fov_deg_min: float = -60.0
    vertical_fov_deg_max: float = 60.0
    max_range: float = 10.0
    min_range: float = 0.2
    return_pointcloud: bool = True
    pointcloud_in_world_frame: bool = True
    segmentation_camera: bool = False
    normalize_range: bool = False
    min_translation: List[float] = field(default_factory=lambda: [0.07, -0.06, 0.02])
    max_translation: List[float] = field(default_factory=lambda: [0.12, 0.03, 0.06])
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.08287454e-06,
            std_b=-4.07347360e-06, std_c=5.30757302e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.01))
