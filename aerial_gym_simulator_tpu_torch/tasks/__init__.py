"""Task registration by name."""

from __future__ import annotations


def register_all():
    from ..registry.registries import task_registry
    from .navigation_task import NavigationTask, NavigationTaskConfig
    from .position_setpoint_task import PositionSetpointTask, PositionSetpointTaskConfig

    task_registry.register_task("navigation_task", NavigationTask, NavigationTaskConfig)
    task_registry.register_task("position_setpoint_task", PositionSetpointTask,
                                PositionSetpointTaskConfig)
