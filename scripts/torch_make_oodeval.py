"""Rebuild the proc_120 OOD eval shapes as a tiny eval-only dataset, with
the PyTorch port (``points2surf_tpu_torch``; counterpart of
``scripts/make_oodeval.py``).

Procedural meshes are deterministic in (seed, style), so the port's
``datagen.procedural.generate_mesh`` writes the same base meshes, byte for
byte, as the JAX package's script: proc_00061 (the documented
out-of-distribution outlier, thin CSG features) and the other documented
test shapes (docs/VALIDATION.md).

Usage:
  python scripts/torch_make_oodeval.py          # writes base meshes + ini
  python -m points2surf_tpu_torch.cli.make_dataset --name proc_oodeval

``--out_root`` writes the dataset elsewhere than
``datasets/proc_oodeval``.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from points2surf_tpu_torch.datagen.procedural import generate_mesh  # noqa: E402
from points2surf_tpu_torch.utils import mesh_io  # noqa: E402

SEEDS = [26, 59, 61, 79, 11, 43]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_root",
                    default=os.path.join(ROOT, "datasets", "proc_oodeval"),
                    help="the dataset directory to write")
    args = ap.parse_args(argv)
    out = os.path.join(args.out_root, "00_base_meshes")
    os.makedirs(out, exist_ok=True)
    for seed in SEEDS:
        f = os.path.join(out, f"proc_{seed:05d}.ply")
        if not os.path.isfile(f):
            m = generate_mesh(seed, None)  # styles=None = proc_120's draw
            mesh_io.write_ply(f, m.vertices, m.faces)
            print(f"wrote {f} ({len(m.faces)} faces)")
    with open(os.path.join(args.out_root, "settings.ini"), "w") as fh:
        fh.write("[general]\nonly_for_evaluation = 1\n")
    print("done; run cli.make_dataset --name proc_oodeval next")


if __name__ == "__main__":
    main()
