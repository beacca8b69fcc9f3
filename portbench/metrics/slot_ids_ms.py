"""``slot_ids_ms`` (engine and executor, ``core/partition.py::_fused_ids``):
the card's time under ``repro.lookup.slot_ids``, each slot's chunk-local
ids and the hot/cold split, a batch (median over the profiled stretch,
``portbench/spans.py``).  Off the card: nothing."""
from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "lookup.slot_ids")
