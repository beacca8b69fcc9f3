"""``rejoin_ms`` (engine and executor, ``core/partition.py::_sparse_rejoin``
and the other rejoins): the card's time under ``repro.lookup.rejoin``, the
plan cores' partials joined into the pooled output, a batch (median over
the profiled stretch, ``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup.rejoin")
