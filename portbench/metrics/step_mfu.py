"""``step_mfu`` (model step, ``models/dlrm.py::forward_packed``): the whole
step's share of the card's peak.  The least time of one batch is the larger
of its operations over the f32 peak and its least bytes over the HBM rate
(``yardstick.step_flops``, ``step_bytes``, averaged over the pool), divided
by the window's wall time per completed batch.  Off the card: nothing."""
from portbench import yardstick


def read(ctx):
    if ctx.state.device.type != "cuda" or ctx.completed == 0:
        return None
    cfg, b = ctx.cell.config, ctx.cell.traffic["batch"]
    pool = ctx.state.pool
    least_ms = sum(yardstick.bound(yardstick.step_bytes(cfg, idx), yardstick.step_flops(cfg, b))[0]
                   for idx, _ in pool) / len(pool)
    return 100.0 * least_ms / (ctx.seconds * 1e3 / ctx.completed)
