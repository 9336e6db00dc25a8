"""chain_roofline.recon (%): the eval chains' share of their roofline. The
least time of every chain of every query batch of the window (``costs.
chain_cost`` at the configuration's call sites and the batch size: the
larger of the FLOPs at the fp32-class peak and the bytes at HBM3's), over
the device time of the chain kernels by name in the trace."""

import costs
import devtrace

KERNELS = ("chain_head_kernel", "chain_pool_kernel", "chain_fused_kernel")


def read(ctx):
    device_s = devtrace.op_seconds(ctx.events, *KERNELS)
    batches = ctx.counters.get("batches", 0)
    if device_s <= 0.0 or not batches:
        return None
    _, least_s = costs.chain_cost(ctx.cfg, ctx.counters["batch_size"])
    return 100.0 * least_s * batches / device_s
