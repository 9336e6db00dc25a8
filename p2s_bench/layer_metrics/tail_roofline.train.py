"""tail_roofline.train (%): the train tails' share of their roofline. The
least time of every ``pooled_tail`` of every step of the window (``costs.
tail_cost_step`` at the configuration's call sites and each step's rows:
the 128 -> net product and the six reductions), over the device time of the
fp32 tail kernel by name in the trace."""

import costs
import devtrace

KERNELS = ("pooled_tail_kernel",)


def read(ctx):
    device_s = devtrace.op_seconds(ctx.events, *KERNELS)
    rows = ctx.counters.get("rows", [])
    if device_s <= 0.0 or not rows:
        return None
    least_s = sum(costs.tail_cost_step(ctx.cfg, b)[1] for b in rows)
    return 100.0 * least_s / device_s
