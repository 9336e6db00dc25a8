"""One rank of the port's two-process tests (``tests/test_torch_parallel.py``).

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
  options of the job; returns the final state.
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
    result = {"step": _step, "train": _train}[job["mode"]](job, device)
    torch.save(result, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
