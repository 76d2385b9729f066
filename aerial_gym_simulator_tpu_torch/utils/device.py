"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means CUDA. A host without a usable GPU raises unless the
    caller asked for the CPU explicitly; nothing falls back on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        # The physics and prim packing do small 3x3 f32 products (inertia,
        # rotations); TF32 would round them to ~3 decimal digits. Keep them
        # in full f32 on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
