"""Minimal end-to-end run on the bundled abc_minimal dataset (counterpart of
``points2surf_tpu/cli/full_run.py``; reference full_run.py): train ->
evaluate -> reconstruct -> mesh -> compare, with the same stages, defaults
and output layout, on one device ("cuda" unless the caller asks for the
CPU).

Usage: python -m points2surf_tpu_torch.cli.full_run [--nepoch 10] ...
"""

from __future__ import annotations

import argparse
import os

STAGES = ("train", "eval", "reconstruction", "meshing", "comparison")


def full_run(
    base_dir="datasets",
    dataset="abc_minimal",
    model_name="vanilla",
    out_root=".",
    nepoch=10,
    batch_size=100,
    grid_resolution=128,
    workers=7,
    net_size=1024,
    points_per_patch=300,
    sub_sample_size=1000,
    patches_per_shape=1000,
    device="cuda",
    stage_done=None,
):
    """Returns the Hausdorff/Chamfer CSV's path. ``stage_done(name)``, when
    given, is called after each of :data:`STAGES` (for timing)."""
    from points2surf_tpu_torch.cli import eval_args, train_args
    from points2surf_tpu_torch.cli.full_train import points_to_surf_train
    from points2surf_tpu_torch.evalx import metrics
    from points2surf_tpu_torch.infer import meshing
    from points2surf_tpu_torch.infer.evaluator import points_to_surf_eval

    def done(stage):
        if stage_done is not None:
            stage_done(stage)

    in_dir_train = os.path.join(base_dir, dataset)
    models_dir = os.path.join(out_root, "models")
    results_dir = os.path.join(out_root, "results")
    logs_dir = os.path.join(out_root, "logs")

    rec_epsilon = 3
    certainty_threshold = 13
    sigma = 5

    features = ["imp_surf_magnitude", "imp_surf_sign", "patch_pts_ids",
                "p_index"]

    train_params = [
        "--name", model_name,
        "--desc", model_name,
        "--indir", in_dir_train,
        "--outdir", models_dir,
        "--logdir", logs_dir,
        "--trainset", "trainset.txt",
        "--testset", "valset.txt",
        "--net_size", str(net_size),
        "--nepoch", str(nepoch),
        "--lr", "0.01",
        "--debug", "0",
        "--workers", str(workers),
        "--batchSize", str(batch_size),
        "--points_per_patch", str(points_per_patch),
        "--patches_per_shape", str(patches_per_shape),
        "--sub_sample_size", str(sub_sample_size),
        "--cache_capacity", "10",
        "--patch_radius", "0.0",
        "--single_transformer", "0",
        "--shared_transformer", "0",
        "--patch_center", "mean",
        "--training_order", "random_shape_consecutive",
        "--use_point_stn", "1",
        "--uniform_subsample", "0",
        "--outputs", *features,
    ]
    train_opt = train_args.parse_arguments(train_params)
    points_to_surf_train(train_opt, device=device)
    done("train")

    # validation pass + MSE CSV
    out_dir_val = os.path.join(results_dir, model_name, dataset)
    res_dir_eval = os.path.join(out_dir_val, "eval")
    eval_opt = eval_args.parse_arguments([
        "--indir", in_dir_train,
        "--outdir", out_dir_val,
        "--dataset", "valset.txt",
        "--models", model_name,
        "--modeldir", models_dir,
        "--batchSize", str(batch_size),
        "--workers", str(workers),
        "--cache_capacity", "5",
    ])
    points_to_surf_eval(eval_opt, device=device)
    metrics.eval_predictions(
        os.path.join(res_dir_eval, "eval"),
        os.path.join(in_dir_train, "05_query_dist"),
        os.path.join(res_dir_eval, "rme_comp_res.csv"),
        unsigned=False,
    )
    done("eval")

    # reconstruction pass
    out_dir = os.path.join(results_dir, model_name, dataset)
    res_dir_rec = os.path.join(out_dir, "rec")
    recon_opt = eval_args.parse_arguments([
        "--indir", in_dir_train,
        "--outdir", out_dir,
        "--dataset", "testset.txt",
        "--query_grid_resolution", str(grid_resolution),
        "--reconstruction", "True",
        "--models", model_name,
        "--modeldir", models_dir,
        "--batchSize", str(batch_size),
        "--workers", str(workers),
        "--cache_capacity", "5",
        "--epsilon", str(rec_epsilon),
    ])
    points_to_surf_eval(recon_opt, device=device)
    done("reconstruction")

    meshing.implicit_surface_to_mesh_directory(
        os.path.join(res_dir_rec, "dist_ms"),
        os.path.join(res_dir_rec, "query_pts_ms"),
        os.path.join(res_dir_rec, "vol"),
        os.path.join(res_dir_rec, "mesh"),
        grid_resolution, sigma, certainty_threshold, workers,
        device=device,
    )
    done("meshing")

    csv_file = os.path.join(res_dir_rec, "hausdorff_dist_pred_rec.csv")
    metrics.mesh_comparison(
        new_meshes_dir_abs=os.path.join(res_dir_rec, "mesh"),
        ref_meshes_dir_abs=os.path.join(in_dir_train, "03_meshes"),
        num_processes=workers,
        report_name=csv_file,
        samples_per_model=10000,
        dataset_file_abs=os.path.join(in_dir_train, "testset.txt"),
    )
    done("comparison")
    print("points2surf_tpu_torch full_run is finished!")
    return csv_file


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="datasets")
    p.add_argument("--dataset", default="abc_minimal")
    p.add_argument("--name", default="vanilla")
    p.add_argument("--out_root", default=".")
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--batchSize", type=int, default=100)
    p.add_argument("--query_grid_resolution", type=int, default=128)
    p.add_argument("--workers", type=int, default=7)
    p.add_argument("--net_size", type=int, default=1024)
    p.add_argument("--gpu_idx", type=int, default=0,
                   help="card to run on (cuda:<idx>)")
    a = p.parse_args()
    full_run(
        base_dir=a.base_dir,
        dataset=a.dataset,
        model_name=a.name,
        out_root=a.out_root,
        nepoch=a.nepoch,
        batch_size=a.batchSize,
        grid_resolution=a.query_grid_resolution,
        workers=a.workers,
        net_size=a.net_size,
        device=f"cuda:{a.gpu_idx}",
    )


if __name__ == "__main__":
    main()
