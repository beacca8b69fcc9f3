"""``dedup_unique_share`` (access reduction, the batch dedup of
``kernels/embedding_multi.py``): 100 x the rows the dedup'd gather reads
(``unique_rows``) over the lookups the cache misses (``lookups`` -
``cache_hits``), counted over one pass of the pool (``portbench/spans.py``).
Nothing where the program counts none."""
from portbench import spans


def read(ctx):
    return spans.count_share(ctx, "unique_rows", of_misses=True)
