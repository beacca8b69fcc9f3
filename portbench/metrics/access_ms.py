"""``access_ms`` (kernels, ``kernels/embedding_multi.py::
multi_embedding_bag_ragged``): the card's time under
``repro.lookup.access``, the dedup, the unique-row gather and the access
scatter with the cache fold, a batch (median over the profiled stretch,
``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup.access")
