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
    from .position_setpoint_variants import (
        AccelerationSim2RealConfig,
        EndToEndConfig,
        MorphyConfig,
        PositionSetpointTaskVariant,
        Px4Config,
        ReconfigurableConfig,
        Sim2RealConfig,
    )

    task_registry.register_task("navigation_task", NavigationTask, NavigationTaskConfig)
    task_registry.register_task("position_setpoint_task", PositionSetpointTask,
                                PositionSetpointTaskConfig)
    task_registry.register_task("position_setpoint_task_sim2real",
                                PositionSetpointTaskVariant, Sim2RealConfig)
    task_registry.register_task("position_setpoint_task_acceleration_sim2real",
                                PositionSetpointTaskVariant, AccelerationSim2RealConfig)
    task_registry.register_task("position_setpoint_task_sim2real_end_to_end",
                                PositionSetpointTaskVariant, EndToEndConfig)
    task_registry.register_task("position_setpoint_task_sim2real_px4",
                                PositionSetpointTaskVariant, Px4Config)
    task_registry.register_task("position_setpoint_task_reconfigurable",
                                PositionSetpointTaskVariant, ReconfigurableConfig)
    task_registry.register_task("position_setpoint_task_morphy",
                                PositionSetpointTaskVariant, MorphyConfig)
    task_registry.register_task("lidar_navigation_task", LiDARNavigationTask,
                                LidarNavigationTaskConfig)
    task_registry.register_task("radar_navigation_task", RadarNavigationTask,
                                RadarNavigationTaskConfig)
