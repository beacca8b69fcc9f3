"""``spill_share`` (access reduction, the batch dedup of
``kernels/embedding_multi.py``): 100 x the lookups past ``unique_cap``,
read row by row (``spilled``), over the lookups the cache misses, counted
over one pass of the pool (``portbench/spans.py``).  Nothing where the
program counts none."""
from portbench import spans


def read(ctx):
    return spans.count_share(ctx, "spilled", of_misses=True)
