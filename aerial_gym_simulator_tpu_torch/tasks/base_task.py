"""BaseTask: the gym-style API every task offers (counterpart of the JAX
package's ``tasks/base_task.py``).

A task owns its reward, observation packing, episode bookkeeping and
curriculum, and composes the whole step (sim substeps, reward,
termination, masked auto-reset, observation) on the sim's device.
"""

from __future__ import annotations

import numpy as np


class BaseTask:
    def __init__(self, task_config):
        self.task_config = task_config
        seed = getattr(task_config, "seed", 0)
        if seed == -1:
            seed = np.random.randint(0, 2**31 - 1)
        self.seed(seed)

    def seed(self, seed: int):
        self._seed = int(seed)
        np.random.seed(self._seed)
        return self._seed

    # gym-style API ---------------------------------------------------------
    def reset(self):
        raise NotImplementedError

    def reset_idx(self, env_ids):
        raise NotImplementedError

    def step(self, actions):
        raise NotImplementedError

    def render(self):
        return None

    def close(self):
        pass
