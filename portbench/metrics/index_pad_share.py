"""``index_pad_share`` (engine and executor, ``core/partition.py::
partitioned_lookup``'s index copy): 100 x (1 - ``lookups`` /
``index_entries``), the share of the ``(N, B, s)`` indices the copy moves
that are ``-1`` padding, counted over one pass of the pool
(``portbench/spans.py``).  Zero where every table is one-hot and the plan
has no symmetric group (``lookups`` counts the slots' lookups alone, as in
every cell).  Nothing where the program counts neither."""
from portbench import spans


def read(ctx):
    got = spans.program(ctx)["counts"]
    if not got or not got.get("index_entries") or "lookups" not in got:
        return None
    return 100.0 * (1.0 - got["lookups"] / got["index_entries"])
