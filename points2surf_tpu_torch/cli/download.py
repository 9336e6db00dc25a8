"""Dataset / model download helpers (counterpart of
``points2surf_tpu/cli/download.py``; reference datasets/download_*.py,
models/download_*.py): fetch zips from the TU Wien server and extract.

Usage:
  python -m points2surf_tpu_torch.cli.download [datasets|models] [names...]
  python -m points2surf_tpu_torch.cli.download --from_local_zip DIR [kind] [names...]

``--from_local_zip DIR``: install pre-staged zips instead of fetching, for
a host without network access. DIR must hold the original zip filenames
(erler-2020-p2s-<name>.zip); each is unpacked into the reference layout
exactly like a download, with a SHA-256 printed for provenance. Datasets go
to ``datasets/``, models to ``models/``, under the working directory.
"""

from __future__ import annotations

import hashlib
import os
import sys
import urllib.error
import urllib.request
import zipfile

BASE_URL = "https://www.cg.tuwien.ac.at/research/publications/2020/erler-2020-p2s/"

# zip names exactly as the reference's own download scripts fetch them
# (datasets/download_datasets_*.py, models/download_models_*.py — each
# dataset zip bundles its noise variants, e.g. famous.zip contains
# famous_original/noisefree/sparse/dense/extra_noisy)
DATASETS = {
    "abc": "erler-2020-p2s-abc.zip",
    "abc_training": "erler-2020-p2s-abc_training.zip",
    "famous": "erler-2020-p2s-famous.zip",
    "thingi10k": "erler-2020-p2s-thingi10k.zip",
    "real_world": "erler-2020-p2s-real_world.zip",
}
MODELS = {
    "vanilla": "erler-2020-p2s-vanilla_model.zip",
    "max": "erler-2020-p2s-max_model.zip",
    "ablation": "erler-2020-p2s-ablation_models.zip",
}


def download_and_unzip(url: str, target_dir: str) -> bool:
    os.makedirs(target_dir, exist_ok=True)
    zip_path = os.path.join(target_dir, os.path.basename(url))
    try:
        print(f"downloading {url}")
        urllib.request.urlretrieve(url, zip_path)
    except (urllib.error.URLError, OSError) as e:
        print(f"download failed ({e}); if this host has no egress, fetch "
              f"{url} elsewhere and unzip into {target_dir}")
        return False
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(target_dir)
    os.remove(zip_path)
    return True


def install_local_zip(zip_path: str, target_dir: str) -> bool:
    """Unpack a pre-staged zip into the reference layout (the no-egress
    path of download_and_unzip); prints a SHA-256 for provenance."""
    if not os.path.isfile(zip_path):
        print(f"missing local zip: {zip_path}")
        return False
    h = hashlib.sha256()
    with open(zip_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    os.makedirs(target_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(target_dir)
    print(f"installed {os.path.basename(zip_path)} -> {target_dir} "
          f"(sha256 {h.hexdigest()})")
    return True


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    local_dir = None
    if argv and argv[0] == "--from_local_zip":
        if len(argv) < 2:
            print("--from_local_zip requires a directory")
            return 2
        local_dir = argv[1]
        argv = argv[2:]
    kind = argv[0] if argv else "datasets"
    table = DATASETS if kind == "datasets" else MODELS
    target = "datasets" if kind == "datasets" else "models"
    names = argv[1:] or list(table)
    rc = 0
    for name in names:
        if name not in table:
            print(f"unknown {kind} name: {name} (known: {sorted(table)})")
            rc = 2
            continue
        if local_dir is not None:
            ok = install_local_zip(
                os.path.join(local_dir, table[name]), target
            )
        else:
            ok = download_and_unzip(BASE_URL + table[name], target)
        rc = rc if ok else 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
