"""``mlp_ms`` (model step, ``models/dlrm.py::forward_packed``): the card's
time under ``repro.step.bottom_mlp`` and ``repro.step.top_mlp`` together, a
batch (median over the profiled stretch, ``portbench/spans.py``).  Off the
card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "step.bottom_mlp", "step.top_mlp")
