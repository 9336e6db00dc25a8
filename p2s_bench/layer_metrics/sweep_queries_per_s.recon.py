"""sweep_queries_per_s.recon (queries/s): the window's queries over the
seconds of their sweeps and fetches alone (the harness's spans; the fetch of
a sweep cut by the deadline is its wait for the card), without the mesh
stages: the query path's own rate, steadier than the end-to-end rate."""


def read(ctx):
    seconds = ctx.spans.total("sweep", "fetch", since=ctx.t_open)
    queries = ctx.counters.get("queries", 0)
    if seconds <= 0.0 or not queries:
        return None
    return queries / seconds
