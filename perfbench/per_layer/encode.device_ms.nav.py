"""encode.device_ms.nav: the device time of the kernels, copies and sets
launched inside the port's ``encode`` spans
(``models/vae.FrozenImageEncoder.encode``: the ViT encoder and its
attention kernel), over their number in the traced slice (ms;
``harness/program_spans.py``)."""

from perfbench.harness.program_spans import totals


def read(ctx):
    t = totals(ctx, "encode")
    return None if t is None else t["device_us"] / t["calls"] * 1e-3
