"""Training-metrics writer: ``metrics.jsonl``, TensorBoard and wandb.

Counterpart of ``aerial_gym_simulator_tpu/utils/metrics.py``. One writer
serves every training entry point: the trainer reads its scalars back once
per log point and hands them to ``write``, which fans them out to

- ``<logdir>/metrics.jsonl``, one JSON object per line
  (``{"step": int, **floats}``), which always works;
- TensorBoard event files through ``torch.utils.tensorboard`` where the
  ``tensorboard`` package imports (a warning otherwise);
- wandb under ``track="wandb"`` where it imports (a warning otherwise).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Mapping, Optional

logger = logging.getLogger(__name__)


class MetricsWriter:
    """Fan-out scalar writer. ``logdir=None`` without ``track`` is a
    disabled writer whose calls do nothing."""

    def __init__(self, logdir: Optional[str], run_name: str = "run",
                 track: Optional[str] = None):
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        self._wandb = None
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a", buffering=1)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=logdir)
            except Exception as e:
                logger.warning("tensorboard writer unavailable (%s); metrics.jsonl only", e)
        # wandb streams without a logdir too
        if track == "wandb":
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project="aerial_gym_tpu", name=run_name, dir=logdir)
            except Exception as e:
                logger.warning("wandb unavailable (%s)", e)

    @property
    def enabled(self) -> bool:
        return self._jsonl is not None or self._tb is not None or self._wandb is not None

    def write(self, step: int, metrics: Mapping[str, float]):
        if not self.enabled:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": int(step), **scalars}) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, int(step))
        if self._wandb is not None:
            self._wandb.log(scalars, step=int(step))

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
