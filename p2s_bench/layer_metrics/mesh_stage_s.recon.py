"""mesh_stage_s.recon (s): host seconds per shape visit in the mesh entry
points on the window's own thread (``infer/meshing._device_volume`` and
``_extract_and_write``: the volume, marching and the mesh PLY), from the
harness's spans, over the visits whose sweep finished. The writes on the
writer threads overlap them and are not counted."""

STAGES = ("volume", "marching")


def read(ctx):
    visits = ctx.counters.get("visits", 0)
    if not visits:
        return None
    return ctx.spans.total(*STAGES, since=ctx.t_open) / visits
