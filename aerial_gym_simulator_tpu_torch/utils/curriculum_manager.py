"""Host-side curriculum level manager, a copy of the JAX package's
``utils/curriculum_manager.py`` (the reference's
utils/curriculum_manager.py).

The navigation tasks run their curriculum on the device; this standalone
manager is for user tasks that keep the level in a host-side loop.
"""

from __future__ import annotations


class CurriculumManager:
    def __init__(self, num_envs, min_level, max_level, level_step, device=None):
        self.num_envs = num_envs
        self.min_level = min_level
        self.max_level = max_level
        self.level_step = level_step
        self.current_level = min_level
        self.level_list = list(range(min_level, max_level + 1, level_step))
        self.max_level_obtained = max(self.current_level, 0)

    def increase_curriculum_level(self):
        self.current_level = min(self.current_level + self.level_step, self.max_level)
        self.max_level_obtained = max(self.current_level, self.max_level_obtained)

    def decrease_curriculum_level(self):
        self.current_level = max(self.current_level - self.level_step, self.min_level)

    def get_current_level(self):
        return self.current_level
