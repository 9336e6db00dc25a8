"""Dataset generation entry point (counterpart of
``points2surf_tpu/cli/make_dataset.py``; reference make_dataset.py
__main__). The device stages run on one device, "cuda" unless the caller
of :func:`main` asks for the CPU.

Usage:
  python -m points2surf_tpu_torch.cli.make_dataset --name mydataset \\
      [--base_dir datasets] [--num_query_pts 2000] [--workers 4] \\
      [--scanner native|blensor --blensor_bin <path>]
"""

from __future__ import annotations

import argparse


def main(args=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True, help="dataset dir name")
    p.add_argument("--base_dir", default="datasets")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--num_query_pts", type=int, default=2000)
    p.add_argument("--num_max_faces", type=int, default=50000)
    p.add_argument("--far_query_pts_ratio", type=float, default=0.1)
    p.add_argument("--scanner", default="native",
                   choices=["native", "blensor"])
    p.add_argument("--blensor_bin", default="blensor/blender")
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--pc_only", type=int, default=0,
                   help="1: point-cloud-only dataset (make_pc_dataset)")
    p.add_argument("--target_num_points", type=int, default=50000)
    p.add_argument("--procedural", type=int, default=0,
                   help="generate N procedural watertight base meshes "
                        "first (ABC stand-in, datagen/procedural.py)")
    p.add_argument("--procedural_seed", type=int, default=0)
    p.add_argument("--procedural_styles", nargs="+", default=None,
                   help="style cycle for the procedural meshes "
                        "(csg bumpy hull thin); default mixes csg-heavy")
    a = p.parse_args(args)

    if a.procedural > 0:
        import os

        from points2surf_tpu_torch.datagen.procedural import (
            make_procedural_meshes)

        out = os.path.join(a.base_dir, a.name)
        names = make_procedural_meshes(out, a.procedural,
                                       seed=a.procedural_seed,
                                       styles=a.procedural_styles)
        print(f"procedural: wrote {len(names)} base meshes to "
              f"{out}/00_base_meshes")

    if a.pc_only:
        from points2surf_tpu_torch.datagen.make_pc_dataset import (
            make_pc_dataset)

        make_pc_dataset(a.name, base_dir=a.base_dir,
                        target_num_points=a.target_num_points,
                        num_processes=a.workers)
        return

    from points2surf_tpu_torch.datagen.make_dataset import make_dataset

    make_dataset(
        a.name, base_dir=a.base_dir, num_processes=a.workers,
        num_query_pts=a.num_query_pts, num_max_faces=a.num_max_faces,
        far_query_pts_ratio=a.far_query_pts_ratio, debug=bool(a.debug),
        scanner=a.scanner, blensor_bin=a.blensor_bin, device=device,
    )


if __name__ == "__main__":
    main()
