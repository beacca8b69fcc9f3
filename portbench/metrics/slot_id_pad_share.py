"""``slot_id_pad_share`` (engine and executor, ``core/partition.py::
_slot_indices``): 100 x (1 - ``lookups`` / ``slot_id_entries``), the share
of every slot's ``(K, S, B, s)`` ids that stand for no lookup (another
slot's rows, a table's padding, an empty slot), counted over one pass of
the pool (``portbench/spans.py``).  Nothing where the program counts
neither."""
from portbench import spans


def read(ctx):
    got = spans.program(ctx)["counts"]
    if not got or not got.get("slot_id_entries") or "lookups" not in got:
        return None
    return 100.0 * (1.0 - got["lookups"] / got["slot_id_entries"])
