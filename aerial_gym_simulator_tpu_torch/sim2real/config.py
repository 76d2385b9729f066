"""Deployment-side dimension constants.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/config.py`` (a copy):
the navigation observation layout the ROS node and the inference classes
use, as in the reference's deployment configuration."""

IMAGE_WIDTH = 480
IMAGE_HEIGHT = 270
LATENT_SPACE = 64
IMAGE_DIMENSIONS = IMAGE_WIDTH * IMAGE_HEIGHT
GOAL_DIR_DIMS = 3
GOAL_MAG_DIMS = 1
ATTITUDE_DIMS = 3
LIN_VELOCITY_DIMS = 3
ANG_VELOCITY_DIMS = 3
ACTION_DIMS = 4
TOTAL_IP_DIMS = (GOAL_DIR_DIMS + GOAL_MAG_DIMS + ATTITUDE_DIMS
                 + LIN_VELOCITY_DIMS + ANG_VELOCITY_DIMS + ACTION_DIMS)
TOTAL_OBS_DIMS = TOTAL_IP_DIMS + LATENT_SPACE
