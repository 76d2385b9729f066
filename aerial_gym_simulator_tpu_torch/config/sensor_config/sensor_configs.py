"""Depth camera config, copied from the JAX package's
``config/sensor_config/sensor_configs.py`` and cut to the base camera."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
