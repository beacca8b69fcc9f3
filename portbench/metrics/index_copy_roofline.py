"""``index_copy_roofline`` (engine and executor, ``core/partition.py::
partitioned_lookup``'s index copy): the least time of the bytes the copy
moves from the host a batch (the program's ``index_copy_bytes`` counter
over one pass of the pool, ``portbench/spans.py``, over the pool's
batches) at :data:`PCIE_BYTES_PER_S`, over the card's time under
``repro.lookup.index_copy`` a batch (median over the profiled stretch).
Off the card, or where the program records no such span or counter:
nothing."""
from portbench import spans

# one direction of PCIe Gen5 x16, the H100 SXM's host link: NVIDIA's data
# sheet gives 128 GB/s, which counts both directions
PCIE_BYTES_PER_S = 64e9


def read(ctx):
    got = spans.program(ctx)["counts"]
    if not got or "index_copy_bytes" not in got:
        return None
    ms = spans.device_ms(ctx, "lookup.index_copy")
    if not ms:
        return None
    least_ms = got["index_copy_bytes"] / len(ctx.state.pool) / PCIE_BYTES_PER_S * 1e3
    return 100.0 * least_ms / ms
