"""``interact_ms`` (model step, ``models/dlrm.py::interact``): the card's
time under ``repro.step.interact``, a batch (median over the profiled
stretch, ``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "step.interact")
