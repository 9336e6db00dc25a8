"""mfu.train (%): the model FLOPs of the window's steps (``costs.model_flop``
per patch, times 3 for the forward and the backward) over the window's
length and the fp32-class peak."""

import costs


def read(ctx):
    patches = ctx.counters.get("patches", 0)
    if not patches:
        return None
    flop = 3.0 * costs.model_flop(ctx.cfg) * patches
    return 100.0 * flop / ctx.window_s / costs.PEAK_FLOPS_FP32
