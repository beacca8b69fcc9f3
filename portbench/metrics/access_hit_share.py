"""``access_hit_share`` (access reduction, the hot/cold split of
``core/partition.py::_fused_ids``): 100 x the program's ``cache_hits``
counter over its ``lookups``, counted over one pass of the pool
(``portbench/spans.py``); the inside twin of ``cache_hit_share``.  Nothing
where the program counts none."""
from portbench import spans


def read(ctx):
    return spans.count_share(ctx, "cache_hits")
