"""``lookup_roofline`` (kernels, ``csrc/*.cu`` through ``kernels/*.py``): the
pooled lookup's least bytes (``yardstick.lookup_bytes``: the indices, each
distinct row once, the pooled f32 output) over the HBM rate, divided by the
card's time for every kernel and copy one ``engine.lookup`` launches
(``yardstick.profile_calls`` on the pool's first batch).  Off the card, or
when the profiler kept no session: nothing."""
from portbench import yardstick


def read(ctx):
    if ctx.state.device.type != "cuda":
        return None
    idx = ctx.state.pool[0][0]
    engine = ctx.state.engine
    prof = yardstick.profile_calls(lambda: engine.lookup(idx))
    if prof["device_ms"] is None:
        return None
    least_ms = yardstick.bound(yardstick.lookup_bytes(ctx.cell.config, idx), 0)[0]
    return 100.0 * least_ms / prof["device_ms"]
