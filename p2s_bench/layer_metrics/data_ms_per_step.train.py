"""data_ms_per_step.train (ms): host milliseconds per step in the harness's
calls into ``data/`` (the plan's next batch, with the pipeline's extraction
of a batch that spans two shapes; the store, the draws and the uploads of a
one-shape batch; the next shape's cloud), from its spans in the window."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps:
        return None
    return 1e3 * ctx.spans.total("data", since=ctx.t_open) / steps
