"""Comparators that the kinds' checks share. Each turns a program's output
and the reference's into one number of the comparison that decides
``correct``; the kinds choose which numbers a cell has and the limits file
of the cell (``limits/<workload>.json``) holds each one's limit."""

from __future__ import annotations

import torch

STATE_COMPARED = ("pos", "quat", "linvel", "angvel", "motor_thrust")
DEPTH_TOL = 1e-4        # normalised depth: 1 mm of the camera's 10 m range


def rows(d, index):
    return {k: v.index_select(0, index) for k, v in d.items()}


def state_gap(got, ref, keep, fields=STATE_COMPARED):
    """The worst field's max abs gap over the reference field's RMS, on the
    envs ``keep`` selects."""
    gap = 0.0
    for k in fields:
        a, b = got[k][keep].float(), ref[k][keep].float()
        if a.numel():
            scale = max(float(b.pow(2).mean().sqrt()), 1e-6)
            gap = max(gap, float((a - b).abs().max()) / scale)
    return gap


def count_unequal(a, b):
    return float((a.float() != b.float()).sum())


def depth_mismatch_share(got, ref, tol=DEPTH_TOL):
    return float(((got.float() - ref.float()).abs() > tol).float().mean())


def unequal_share(got, ref):
    return float((got != ref).float().mean())


def max_gap_over_rms(got, ref):
    a, b = got.float(), ref.float()
    return float((a - b).abs().max()) / max(float(b.pow(2).mean().sqrt()), 1e-6)


def rms_gap_over_rms(got, ref):
    a, b = got.float(), ref.float()
    return float((a - b).pow(2).mean().sqrt() / torch.clamp(b.pow(2).mean().sqrt(), min=1e-6))


def worst(readings):
    """Worst value of each number over several captures."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
