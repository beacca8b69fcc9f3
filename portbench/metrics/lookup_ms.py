"""``lookup_ms`` (engine and executor, ``engine.py::lookup`` over
``core/partition.py``): host clock around ``engine.lookup(indices)`` and a
synchronize, the median over two passes of the pool's batches, timed from
outside the program."""
import statistics
import time


def read(ctx):
    import torch

    engine, pool = ctx.state.engine, ctx.state.pool
    sync = torch.cuda.synchronize if ctx.state.device.type == "cuda" else (lambda: None)
    engine.lookup(pool[0][0])
    sync()
    times = []
    for _ in range(2):
        for idx, _ in pool:
            t = time.perf_counter()
            engine.lookup(idx)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)
