"""mfu.recon (%): the model FLOPs of the window's queries (``costs.
model_flop`` per query, padding rows not counted) over the window's length
and the fp32-class peak."""

import costs


def read(ctx):
    queries = ctx.counters.get("queries", 0)
    if not queries:
        return None
    flop = costs.model_flop(ctx.cfg) * queries
    return 100.0 * flop / ctx.window_s / costs.PEAK_FLOPS_FP32
