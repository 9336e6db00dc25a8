"""One rank of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_sharding.py``).

    python tests/_torch_parallel_worker.py RANK WORLD STORE JOB OUT

Joins a gloo process group through the ``file://`` store STORE, runs the job
that the test saved to JOB (``torch.save``) and saves this rank's results to
OUT. Jobs:

* ``step``: fused train steps of a ``PointsToSurfModel`` from the job's
  weights on this rank's rows of the job's global batch and of its draws
  (the job's ``TrainDraws``, or draws of a generator seeded by the job);
  returns each step's losses, metrics and state after it, the first
  step's gradients and the ``pooled_tail`` launches;
* ``train``: ``cli.full_train.points_to_surf_train`` with this rank's
  options of the job; returns the final state;
* ``grid``: the ``step`` job's steps on a ``make_mesh(data=, model=)``
  grid with the model partitioned by ``min_dim``, after a query sweep
  (``make_sdf_query_fn(mesh=)``) of the job's queries and draws; returns
  the losses, the first step's gradients and the state after each step
  gathered whole (``gather_full``), the sweep's distances, the kernel
  launches and ``replicate_array`` of the rank's index;
* ``feat``: a ``PointNetFeat`` of the job (the multi-scale encoder) on a
  ``make_mesh(data=, model=)`` grid, partitioned by ``min_dim``: one
  train-mode forward of this data rank's rows of the job's points, the
  backward of the mean of its codewords weighted by the job's weights
  (gradients averaged over the data ranks, as ``TrainStep`` does), then an
  eval forward; returns both forwards' codewords of this rank's rows, and
  the gradients and state gathered whole;
* ``model1``: the ``step`` job twice from the same state, first as data
  parallelism alone, then after ``make_mesh(model=1)``; returns both runs
  and the collectives each launched (name, shape, group).
"""

import os
import sys

import torch


def _step(job, device):
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.ops import patches as tp
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.parallel import distributed, replicate
    from points2surf_tpu_torch.train.trainer import make_train_step

    model = PointsToSurfModel(**job["model_kw"])
    model.load_state_dict(job["state"], strict=True)
    model = replicate(model.to(device))
    cfg = tp.PatchConfig(**job["cfg"])
    steps = make_train_step(model, job["outputs"], patch_cfg=cfg,
                            lr=job["lr"], momentum=job["momentum"])
    pts = job["pts"].to(device)
    n_valid = job["n_valid"]
    gen = torch.Generator(device=device).manual_seed(job.get("seed", 0))
    out = {"losses": [], "metrics": [], "launches": 0}
    pooled_tail_reductions.launches = 0
    for i in range(job["steps"]):
        q, gt = job["q"][i], job["gt"][i]
        lo, hi = distributed.rank_rows(len(q))
        if job.get("draws") is not None:
            draws = job["draws"][i]
        else:
            draws = tp.draw_batch(gen, (hi - lo) * distributed.world_size(),
                                  pts.shape[0], cfg, train=True,
                                  n_valid=n_valid)
        if distributed.world_size() > 1:
            draws = draws.rows(lo, hi, chunk=cfg.query_chunk)
        losses, metrics = steps.train_step_fused(
            pts, q[lo:hi].to(device), n_valid, gt[lo:hi].to(device),
            draws.to(device))
        out["losses"].append(losses.cpu())
        out["metrics"].append({k: v.cpu() for k, v in metrics.items()})
        if i == 0:
            out["grads"] = {k: p.grad.detach().cpu().clone()
                            for k, p in model.named_parameters()}
        out.setdefault("states", []).append(
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()})
    out["launches"] = pooled_tail_reductions.launches
    return out


def _grid(job, device):
    from points2surf_tpu_torch.infer.query import make_sdf_query_fn
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.ops import patches as tp
    from points2surf_tpu_torch.ops.kernels.chain_pool import (
        chain_head, chain_pool)
    from points2surf_tpu_torch.ops.kernels.pooled_tail import (
        pooled_tail_reductions)
    from points2surf_tpu_torch.parallel import (
        distributed, gather_full, make_mesh, partition_params, replicate,
        replicate_array)
    from points2surf_tpu_torch.train.trainer import make_train_step

    grid = make_mesh(data=job["data"], model=job["model"])
    mine = torch.full((3,), float(distributed.rank()))
    model = PointsToSurfModel(**job["model_kw"])
    model.load_state_dict(job["state"], strict=True)
    partition_params(model, grid, min_dim=job["min_dim"])
    model = replicate(model.to(device))
    cfg = tp.PatchConfig(**job["cfg"])
    pts, n_valid = job["pts"].to(device), job["n_valid"]
    out = {"losses": [], "states": [], "replicated": replicate_array(mine),
           "shards": sorted(
        name for name, mod in model.named_modules()
        if getattr(mod, "sharded", False))}
    chain_head.launches = chain_pool.launches = 0
    chain_pool.launches_fused_bf16 = 0
    query = make_sdf_query_fn(model, job["outputs"],
                              tp.PatchConfig(**job["query_cfg"]),
                              fixed_radius=False, mesh=grid)
    out["query"] = query(pts, job["queries"].to(device), n_valid,
                         job["query_draws"].to(device)).cpu()
    out["chain_launches"] = (chain_head.launches, chain_pool.launches,
                             chain_pool.launches_fused_bf16)
    steps = make_train_step(model, job["outputs"], patch_cfg=cfg,
                            lr=job["lr"], momentum=job["momentum"])
    pooled_tail_reductions.launches = pooled_tail_reductions.launches_bf16 = 0
    for i in range(job["steps"]):
        q, gt = job["q"][i], job["gt"][i]
        lo, hi = distributed.rank_rows(len(q))
        draws = job["draws"][i]
        if distributed.data_size() > 1:
            draws = draws.rows(lo, hi, chunk=cfg.query_chunk)
        losses, _ = steps.train_step_fused(
            pts, q[lo:hi].to(device), n_valid, gt[lo:hi].to(device),
            draws.to(device))
        out["losses"].append(losses.cpu())
        if i == 0:
            out["grads"] = {k: v.cpu() for k, v in gather_full(
                model, grid, {k: p.grad for k, p in
                              model.named_parameters()}).items()}
        out["states"].append({k: v.cpu().clone() for k, v in
                              gather_full(model, grid).items()})
    out["tail_launches"] = (pooled_tail_reductions.launches,
                            pooled_tail_reductions.launches_bf16)
    return out


def _feat(job, device):
    from points2surf_tpu_torch.models.pointnet import PointNetFeat
    from points2surf_tpu_torch.parallel import (
        distributed, gather_full, make_mesh, partition_params, replicate)

    grid = make_mesh(data=job["data"], model=job["model"])
    feat = PointNetFeat(**job["feat_kw"])
    feat.load_state_dict(job["state"], strict=True)
    partition_params(feat, grid, min_dim=job["min_dim"])
    feat = replicate(feat.to(device)).train()
    lo, hi = distributed.rank_rows(len(job["x"]))
    x, w = job["x"][lo:hi].to(device), job["w"][lo:hi].to(device)
    code = feat(x)[0]
    torch.sum(code.float() * w, dim=1).mean().backward()
    grads = [p.grad for p in feat.parameters()]
    flat = distributed.mean_over_ranks_(torch.cat([g.reshape(-1)
                                                   for g in grads]))
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()
    out = {"code": code.detach().float().cpu(),
           "grads": {k: v.cpu() for k, v in gather_full(
               feat, grid, {k: p.grad for k, p in
                            feat.named_parameters()}).items()},
           "state": {k: v.cpu().clone()
                     for k, v in gather_full(feat, grid).items()}}
    with torch.no_grad():
        out["eval"] = feat.eval()(x)[0].float().cpu()
    return out


def _model1(job, device):
    """Data parallelism alone and the same after ``make_mesh(model=1)``,
    with the collectives each launched."""
    import torch.distributed as dist

    from points2surf_tpu_torch.parallel import make_mesh

    runs = []
    for grid in (False, True):
        if grid:
            make_mesh(model=1)
        log = []
        real = {k: getattr(dist, k) for k in ("all_reduce", "broadcast",
                                               "new_group")}

        def logged(name):
            def f(*a, **k):
                t = a[0] if a and torch.is_tensor(a[0]) else None
                log.append((name, None if t is None else tuple(t.shape),
                            k.get("group") is not None))
                return real[name](*a, **k)
            return f

        for k in real:
            setattr(dist, k, logged(k))
        try:
            runs.append((_step(job, device), log))
        finally:
            for k, f in real.items():
                setattr(dist, k, f)
    return {"runs": runs}


def _train(job, device):
    from points2surf_tpu_torch.cli.full_train import points_to_surf_train
    from points2surf_tpu_torch.parallel import distributed

    trainer = points_to_surf_train(job["opts"][distributed.rank()],
                                   device=device)
    return {"state": {k: v.detach().cpu().clone()
                      for k, v in trainer.model.state_dict().items()}}


def main():
    rank, world, store, job_path, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK="0")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from points2surf_tpu_torch.parallel import distributed

    job = torch.load(job_path, weights_only=False)
    assert distributed.initialize(backend="gloo",
                                  init_method=f"file://{store}")
    assert distributed.world_size() == int(world)
    device = torch.device(job.get("device", "cpu"))
    result = {"step": _step, "train": _train, "grid": _grid, "feat": _feat,
              "model1": _model1}[job["mode"]](job, device)
    torch.save(result, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
