"""``cache_hit_share`` (access reduction, ``kernels/embedding_multi.py``'s
hot-row cache): the pool's lookups that the residency cache serves, over
all its lookups, counted from the program's own hot/cold split
(``core/partition.py::_fused_ids``) as ``chip_smoke.py::access_summary``
counts them.  Nothing where the pack holds no cache rows."""


def read(ctx):
    import torch

    from repro_torch.core.partition import _fused_ids

    packed = ctx.state.engine.packed
    if not packed.cache_rows:
        return None
    hits = lookups = 0
    for idx, _ in ctx.state.pool:
        lidx, hidx = _fused_ids(packed, torch.as_tensor(idx, device=packed.device))
        h = int((hidx >= 0).sum())
        hits += h
        lookups += int((lidx >= 0).sum()) + h
    return 100.0 * hits / lookups
