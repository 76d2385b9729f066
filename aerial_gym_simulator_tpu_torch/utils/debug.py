"""Debug-mode switches (reference SURVEY 5.2).

Counterpart of ``aerial_gym_simulator_tpu/utils/debug.py``. Eager torch runs
op by op already, so what is left to switch are torch's own counterparts:

  * ``enable_nan_checks(on)`` flips autograd's anomaly detection with its
    NaN check (``torch.autograd.set_detect_anomaly(on, check_nan=True)``;
    ``torch.is_anomaly_enabled()`` reads it back): a backward that produces
    a NaN raises at the forward op that led to it.
  * ``enable_disable_jit(on)`` flips the switch that makes
    ``torch.jit.script`` return its function or module as plain Python
    (``torch.jit._state``'s enabled flag, the ``PYTORCH_JIT=0`` setting).
    The port scripts only its deploy modules (``sim2real/torch_export``);
    eager torch has no other JIT to turn off.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("debug")


def enable_nan_checks(on: bool = True):
    torch.autograd.set_detect_anomaly(on, check_nan=True)
    logger.info(f"anomaly detection with NaN checks = {on}")


def enable_disable_jit(on: bool = True):
    if on:
        torch.jit._state.disable()
    else:
        torch.jit._state.enable()
    logger.info(f"torch.jit.script disabled = {on}")

