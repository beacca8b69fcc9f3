"""``lookup_idle_share`` (device, the H100): the share of the profiled
stretch's window (``portbench/spans.py``) in which the card runs nothing
while the host is inside the program's ``repro.lookup`` span or a span
within it.  Off the card, or where the program records no such span:
nothing."""
from portbench import spans


def read(ctx):
    s = spans.program(ctx)["stretch"]
    if s is None or s["window_s"] <= 0 or "repro.lookup" not in s["device_ms"]:
        return None
    idle = sum(t for name, t in s["idle_s"].items()
               if name == "repro.lookup" or name.startswith("repro.lookup."))
    return 100.0 * idle / s["window_s"]
