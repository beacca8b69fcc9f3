"""``index_copy_ms`` (engine and executor, ``core/partition.py::
partitioned_lookup``): the card's time under ``repro.lookup.index_copy``,
the copy of the host's indices to the card, a batch (median over the
profiled stretch, ``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup.index_copy")
