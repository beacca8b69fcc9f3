"""``scatter_ms`` (engine and executor, ``core/partition.py::_scatter_slots``):
the card's time under ``repro.lookup.scatter``, the per-slot partials added
into per-table partials, a batch (median over the profiled stretch,
``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup.scatter")
