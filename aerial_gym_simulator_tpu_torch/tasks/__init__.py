"""Task registration by name."""

from __future__ import annotations


def register_all():
    from ..registry.registries import task_registry
    from .lidar_navigation_task import (
        LiDARNavigationTask,
        LidarNavigationTaskConfig,
        RadarNavigationTask,
        RadarNavigationTaskConfig,
    )
    from .navigation_task import NavigationTask, NavigationTaskConfig
    from .position_setpoint_task import PositionSetpointTask, PositionSetpointTaskConfig

    task_registry.register_task("navigation_task", NavigationTask, NavigationTaskConfig)
    task_registry.register_task("position_setpoint_task", PositionSetpointTask,
                                PositionSetpointTaskConfig)
    task_registry.register_task("lidar_navigation_task", LiDARNavigationTask,
                                LidarNavigationTaskConfig)
    task_registry.register_task("radar_navigation_task", RadarNavigationTask,
                                RadarNavigationTaskConfig)
