"""``lookup_device_ms`` (engine and executor, ``core/partition.py::
partitioned_lookup``): the card's time for the kernels and copies launched
under the program's ``repro.lookup`` span, a batch, the median over the
profiled stretch (``portbench/spans.py``); the inside twin of
``lookup_ms``.  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup")
