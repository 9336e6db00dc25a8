"""Full evaluation + reconstruction driver (counterpart of
``points2surf_tpu/cli/full_eval.py``; reference full_eval.py), in one
process on one device.

Per dataset: SDF evaluation against GT query distances (when available) +
MSE CSV, grid reconstruction, volume -> mesh extraction, and
Hausdorff/Chamfer comparison CSVs.
"""

from __future__ import annotations

import os
import time


def full_eval(opt, device="cuda"):
    from points2surf_tpu_torch.evalx import metrics
    from points2surf_tpu_torch.infer import meshing
    from points2surf_tpu_torch.infer.evaluator import points_to_surf_eval

    indir_root = opt.indir
    outdir_root = os.path.join(
        opt.outdir, opt.models + os.path.splitext(opt.modelpostfix)[0]
    )
    datasets = opt.dataset if isinstance(opt.dataset, list) else [opt.dataset]
    for dataset in datasets:
        print(f"Evaluating on dataset {dataset}")
        opt.indir = os.path.join(indir_root, os.path.dirname(dataset))
        opt.outdir = os.path.join(outdir_root, os.path.dirname(dataset))
        opt.dataset = os.path.basename(dataset)

        if os.path.exists(os.path.join(opt.indir, "05_query_dist")):
            opt.reconstruction = False
            points_to_surf_eval(opt, device=device)
            res_dir_eval = os.path.join(opt.outdir, "eval")
            metrics.eval_predictions(
                os.path.join(res_dir_eval, "eval"),
                os.path.join(opt.indir, "05_query_dist"),
                os.path.join(res_dir_eval, "rme_comp_res.csv"),
                unsigned=False,
            )

        start = time.time()
        opt.reconstruction = True
        points_to_surf_eval(opt, device=device)
        res_dir_rec = os.path.join(opt.outdir, "rec")
        print(f"Inference of SDF took: {time.time() - start}")

        start = time.time()
        meshing.implicit_surface_to_mesh_directory(
            os.path.join(res_dir_rec, "dist_ms"),
            os.path.join(res_dir_rec, "query_pts_ms"),
            os.path.join(res_dir_rec, "vol"),
            os.path.join(res_dir_rec, "mesh"),
            opt.query_grid_resolution,
            opt.sigma,
            opt.certainty_threshold,
            opt.workers,
            device=device,
        )
        print(f"Meshing took: {time.time() - start}")

        metrics.mesh_comparison(
            new_meshes_dir_abs=os.path.join(res_dir_rec, "mesh"),
            ref_meshes_dir_abs=os.path.join(opt.indir, "03_meshes"),
            num_processes=opt.workers,
            report_name=os.path.join(
                res_dir_rec, "hausdorff_dist_pred_rec.csv"
            ),
            samples_per_model=10000,
            dataset_file_abs=os.path.join(opt.indir, opt.dataset),
        )


def main(args=None):
    from points2surf_tpu_torch.cli.eval_args import parse_arguments

    opt = parse_arguments(args)
    full_eval(opt, device=f"cuda:{opt.gpu_idx}")
    print("points2surf_tpu_torch eval is finished!")


if __name__ == "__main__":
    main()
