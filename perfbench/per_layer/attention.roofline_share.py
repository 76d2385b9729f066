"""attention.roofline_share: the fused-attention forward's least time per
launch at the encoder's shape (``counts/attention.py``, bf16) times the
launches the port's ``attention_cuda.LAUNCHES`` counted in the traced
slice, over the device time of the attention kernels in the slice (%)."""

import re

KERNEL = re.compile(r"\battention_\w*kernel")


def read(ctx):
    launches = sum(v for k, v in ctx["launches"].items() if k.startswith("attention_fwd"))
    device_us = sum(dur for name, _, dur, _ in ctx["trace"].device if KERNEL.search(name))
    if launches <= 0 or device_us <= 0.0 or "attention_s" not in ctx["bounds"]:
        return None
    return 100.0 * launches * ctx["bounds"]["attention_s"] / (device_us * 1e-6)
