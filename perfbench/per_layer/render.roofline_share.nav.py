"""render.roofline_share.nav: ``render.roofline_share``'s rule applied to
the port's ``render`` span inside the navigation task's step: the ray
cast's least time on the first traced step's poses and tables
(``counts/raycast.py``) over the device time of everything launched inside
the slice's first ``render`` span (``sensors/raycast_sensor.render``:
pose, table packing, the ray cast, range limits, normalisation) (%)."""

from perfbench.harness.program_spans import mapped


def read(ctx):
    m = mapped(ctx)
    if m is None or "raycast_s" not in ctx["bounds"]:
        return None
    first = next((r for r in m[0] if r["name"] == "render"), None)
    if first is None or first["device_us"] <= 0.0:
        return None
    return 100.0 * ctx["bounds"]["raycast_s"] / (first["device_us"] * 1e-6)
