"""Sensor configs, copied from the JAX package's
``config/sensor_config/sensor_configs.py``: the depth cameras (base, the
navigation camera, RealSense D455, ToF 8x8, Luxonis OAK-D and OAK-D Pro W,
the stereo pair, the normal/face-id camera), the lidars (base, the
lidar-nav table, Ouster OS0/OS1/OS2/OSDome, pmd flexx2, ST VL53L5CX,
Robosense Airy, the fake radar, the 2-D scanner) and the IMUs (base, Bosch
BMI088, VectorNav VN-100)."""

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
class NavDepthCameraConfig(BaseDepthCameraConfig):
    """The 270x480 depth camera of the navigation task's VAE input."""
    height: int = 270
    width: int = 480


@dataclass
class RsD455Config(BaseDepthCameraConfig):
    """Intel RealSense D455."""
    height: int = 270
    width: int = 480
    horizontal_fov_deg: float = 87.0
    max_range: float = 15.0
    min_range: float = 0.2


# the source ships the same sensor under a second class name
IntelRealSenseD455Config = RsD455Config


@dataclass
class TofCameraConfig(BaseDepthCameraConfig):
    """ST VL53L5CX 8x8 time-of-flight array as a camera."""
    height: int = 8
    width: int = 8
    horizontal_fov_deg: float = 45.0
    max_range: float = 4.0
    min_range: float = 0.02


@dataclass
class LuxonisOakDConfig(BaseDepthCameraConfig):
    """Luxonis OAK-D stereo depth: a fixed mount, no segmentation, noise off."""
    height: int = 270
    width: int = 480
    horizontal_fov_deg: float = 72.0
    max_range: float = 12.0
    min_range: float = 0.7
    segmentation_camera: bool = False
    randomize_placement: bool = False
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, pixel_dropout_prob=0.01))


@dataclass
class LuxonisOakDProWConfig(BaseDepthCameraConfig):
    """Luxonis OAK-D Pro W, the wide-FOV model."""
    height: int = 270
    width: int = 480
    horizontal_fov_deg: float = 127.0
    max_range: float = 12.0
    min_range: float = 0.2
    segmentation_camera: bool = False
    randomize_placement: bool = False
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, pixel_dropout_prob=0.01))


@dataclass
class StereoCameraConfig(BaseDepthCameraConfig):
    """A stereo pair: the right eye sits ``stereo_baseline`` along the
    sensor frame's -x of the left one (the data-frame rotation included),
    and each pixel keeps the farther of the two eyes' depths."""
    height: int = 270
    width: int = 480
    stereo_baseline: float = 0.095


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
class LidarNavConfig(BaseLidarConfig):
    """The 48x120 lidar of the lidar navigation task."""
    height: int = 48
    width: int = 120
    vertical_fov_deg_min: float = -22.5
    vertical_fov_deg_max: float = 22.5


@dataclass
class OS0_64Config(BaseLidarConfig):
    """Ouster OS0-64."""
    height: int = 64
    width: int = 512
    vertical_fov_deg_min: float = -45.0
    vertical_fov_deg_max: float = 45.0
    max_range: float = 35.0
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.36239104e-05,
            std_b=-3.17199061e-04, std_c=9.61903860e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.0))


@dataclass
class OS0_128Config(BaseLidarConfig):
    """Ouster OS0-128."""
    height: int = 128
    width: int = 512
    vertical_fov_deg_min: float = -45.0
    vertical_fov_deg_max: float = 45.0
    max_range: float = 35.0
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.36239104e-05,
            std_b=-3.17199061e-04, std_c=9.61903860e-03,
            mean_offset=-0.05, pixel_dropout_prob=0.0))


@dataclass
class OS1_64Config(BaseLidarConfig):
    """Ouster OS1-64."""
    height: int = 64
    width: int = 512
    vertical_fov_deg_min: float = -22.5
    vertical_fov_deg_max: float = 22.5
    max_range: float = 90.0
    min_range: float = 0.7
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.08287454e-06,
            std_b=-4.07347360e-06, std_c=5.30757302e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.0))
    # OS0-128's sentinels, pinned: the source computes them once in its
    # parent class's body, so this subclass inherits them stale
    far_out_of_range_value: Optional[float] = 35.0
    near_out_of_range_value: Optional[float] = -35.0


@dataclass
class OS2_128Config(BaseLidarConfig):
    """Ouster OS2-128: 240 m range."""
    height: int = 128
    width: int = 512
    vertical_fov_deg_min: float = -11.25
    vertical_fov_deg_max: float = 11.25
    max_range: float = 240.0


@dataclass
class OS2_64Config(BaseLidarConfig):
    """Ouster OS2-64, noise off with the source's stds."""
    height: int = 64
    width: int = 512
    vertical_fov_deg_min: float = -11.25
    vertical_fov_deg_max: float = 11.25
    max_range: float = 200.0
    min_range: float = 0.7
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.08287454e-06,
            std_b=-4.07347360e-06, std_c=5.30757302e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.0))
    # OS0-128's inherited stale sentinels, as for OS1-64
    far_out_of_range_value: Optional[float] = 35.0
    near_out_of_range_value: Optional[float] = -35.0


@dataclass
class PmdFlexx2Config(BaseLidarConfig):
    """pmd flexx2 time-of-flight flash lidar: no segmentation, a wider
    mount range, noise off."""
    height: int = 172
    width: int = 224
    horizontal_fov_deg_min: float = -28.0
    horizontal_fov_deg_max: float = 28.0
    vertical_fov_deg_min: float = -22.0
    vertical_fov_deg_max: float = 22.0
    max_range: float = 5.0
    min_range: float = 0.2
    segmentation_camera: bool = False
    min_translation: List[float] = field(default_factory=lambda: [0.07, -0.06, 0.02])
    max_translation: List[float] = field(default_factory=lambda: [0.12, 0.03, 0.06])
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.08287454e-06,
            std_b=-4.07347360e-06, std_c=5.30757302e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.01))


@dataclass
class StVL53L5CXConfig(BaseLidarConfig):
    """ST VL53L5CX 8x8 ToF: raw metres with a -1.0 out-of-range sentinel,
    a fixed mount, no segmentation, noise off."""
    height: int = 8
    width: int = 8
    horizontal_fov_deg_min: float = -45.0
    horizontal_fov_deg_max: float = 45.0
    vertical_fov_deg_min: float = -45.0
    vertical_fov_deg_max: float = 45.0
    max_range: float = 4.0
    min_range: float = 0.2
    segmentation_camera: bool = False
    normalize_range: bool = False
    randomize_placement: bool = False
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=3.08287454e-06,
            std_b=-4.07347360e-06, std_c=5.30757302e-03,
            mean_offset=-0.025, pixel_dropout_prob=0.0))


@dataclass
class OSDome_64Config(BaseLidarConfig):
    """Ouster dome lidar over the upper hemisphere: a fixed mount, noise off
    with the dome's stds."""
    height: int = 64
    width: int = 512
    vertical_fov_deg_min: float = 0.0
    vertical_fov_deg_max: float = 90.0
    max_range: float = 20.0
    min_range: float = 0.5
    randomize_placement: bool = False
    min_translation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    max_translation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    min_euler_rotation_deg: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    max_euler_rotation_deg: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    sensor_noise: SensorNoiseConfig = field(
        default_factory=lambda: SensorNoiseConfig(
            enable_sensor_noise=False, std_a=0.00038089,
            std_b=-0.00343351, std_c=0.01553284,
            mean_offset=-0.025, pixel_dropout_prob=0.0))
    # the base lidar's sentinels, pinned (its max_range is 20 here)
    far_out_of_range_value: Optional[float] = 10.0
    near_out_of_range_value: Optional[float] = -10.0


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


@dataclass
class Lidar2DConfig(BaseLidarConfig):
    """A planar scanner: one row of 1,024 rays."""
    height: int = 1
    width: int = 1024
    vertical_fov_deg_min: float = 0.0
    vertical_fov_deg_max: float = 0.0


@dataclass
class BaseImuConfig:
    """The base IMU (VectorNav VN-100 noise data): noise and bias terms
    gated by enable_noise / enable_bias, biases re-drawn uniformly in
    +-max_bias_init_value at reset, the mount perturbed within the Euler
    range when randomize_placement."""
    num_sensors: int = 1
    sensor_type: str = "imu"
    world_frame: bool = False
    enable_noise: bool = True
    enable_bias: bool = True
    accel_noise_std: List[float] = field(default_factory=lambda: [
        0.001688956233495657, 0.001688956233495657, 0.001688956233495657])
    gyro_noise_std: List[float] = field(default_factory=lambda: [
        0.0010679343003532472, 0.0010679343003532472, 0.0010679343003532472])
    accel_bias_std: List[float] = field(default_factory=lambda: [
        9.782812831313576e-07, 9.782812831313576e-07, 9.782812831313576e-07])
    gyro_bias_std: List[float] = field(default_factory=lambda: [
        2.6541629581345176e-05, 2.6541629581345176e-05, 2.6541629581345176e-05])
    max_measurement_acceleration: float = 100.0
    max_measurement_angular_velocity: float = 10.0
    max_bias_init_value: List[float] = field(default_factory=lambda: [1e-3] * 6)
    gravity_compensation: bool = False
    randomize_placement: bool = False
    min_euler_rotation_deg: List[float] = field(default_factory=lambda: [-2.0, -2.0, -2.0])
    max_euler_rotation_deg: List[float] = field(default_factory=lambda: [2.0, 2.0, 2.0])


@dataclass
class BoschBmi088Config(BaseImuConfig):
    """Bosch BMI088."""
    accel_noise_std: List[float] = field(
        default_factory=lambda: [0.001569064, 0.001569064, 0.0018632635])
    gyro_noise_std: List[float] = field(
        default_factory=lambda: [0.0002443461, 0.0002443461, 0.0002443461])
    accel_bias_std: List[float] = field(
        default_factory=lambda: [0.001356466, 0.001356466, 0.001356466])
    gyro_bias_std: List[float] = field(
        default_factory=lambda: [1.43527e-05, 1.43527e-05, 1.43527e-05])
    randomize_placement: bool = True


@dataclass
class VN100Config(BaseImuConfig):
    """VectorNav VN-100."""
    accel_noise_std: List[float] = field(
        default_factory=lambda: [0.001372931, 0.001372931, 0.001372931])
    gyro_noise_std: List[float] = field(
        default_factory=lambda: [6.1086524e-05, 6.1086524e-05, 6.1086524e-05])
    accel_bias_std: List[float] = field(
        default_factory=lambda: [9.7828128e-07, 9.7828128e-07, 9.7828128e-07])
    gyro_bias_std: List[float] = field(
        default_factory=lambda: [2.6541630e-05, 2.6541630e-05, 2.6541630e-05])
    randomize_placement: bool = True
