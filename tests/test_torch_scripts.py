"""Port: the user-facing scripts against the JAX package's
(``scripts/torch_make_oodeval.py``, ``torch_sign_error_report.py``,
``torch_flood_sweep.py``).

Each pair runs as a subprocess on the CPU (the JAX scripts with
``JAX_PLATFORMS=cpu``, the port's with ``--device cpu`` where they touch a
device) on one fixture: procedural mesh 79 (a 26-face hull) as the GT mesh,
its grid-32 near-surface queries (from 2,000 surface samples) and
synthetic ``rec/`` predictions, the GT signed distance with every tenth
sign flipped and 5% noise. Held to:

* the OOD base meshes and ``settings.ini``: byte-identical;
* the sign-error report: the same table, every rate equal;
* the flood sweep's CSV (seed filters 0 and 2): the same rows, numbers
  within 1e-5.

The scripts run with one OpenMP thread. The JAX package's marcher
(``native/marching.cpp``) merges its threads' triangles in the order the
threads were scheduled, so its face order, and with it the PLY bytes and
the surface samples that the metrics draw by face, is its single-thread
order only with one thread; the port's marcher emits the single-thread
order with any number.
"""

import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = "proc_00079"


def _run(args, tmp_path, **env):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               P2S_JAX_CACHE=str(tmp_path / "jax_cache"), **env)
    proc = subprocess.run([sys.executable] + args, cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def rec_fixture(tmp_path_factory):
    """A dataset dir with one GT mesh and a results dir with its synthetic
    reconstruction predictions."""
    from points2surf_tpu_torch.datagen.procedural import generate_mesh
    from points2surf_tpu_torch.evalx.metrics import sample_mesh_surface
    from points2surf_tpu_torch.ops import meshdist
    from points2surf_tpu_torch.ops.voxel import grid_query_points
    from points2surf_tpu_torch.utils import mesh_io

    root = tmp_path_factory.mktemp("scripts")
    ds = root / "ds"
    (ds / "03_meshes").mkdir(parents=True)
    mesh = generate_mesh(79, None)
    v, f = mesh.vertices.astype(np.float32), mesh.faces
    mesh_io.write_ply(str(ds / "03_meshes" / f"{SHAPE}.ply"), v, f)
    (ds / "testset.txt").write_text(SHAPE + "\n")
    cloud = sample_mesh_surface(v, f, 2000, np.random.RandomState(1))
    q = grid_query_points(cloud, 32, 3, device="cpu")
    gt = meshdist.signed_distance(v, f, q, device="cpu")
    rng = np.random.RandomState(2)
    pred = np.where(np.arange(len(q)) % 10 == 0, -gt, gt) * (
        1.0 + 0.05 * rng.randn(len(q)))
    res = root / "results" / "m_model" / "ds"
    for sub, arr in (("query_pts_ms", q), ("dist_ms", pred)):
        (res / "rec" / sub).mkdir(parents=True)
        np.save(res / "rec" / sub / f"{SHAPE}.xyz.npy",
                arr.astype(np.float32))
    return root, ds, res


def test_make_oodeval_matches_jax(tmp_path):
    """The JAX script runs from a copy, so it writes under ``tmp_path``."""
    (tmp_path / "scripts").mkdir()
    shutil.copy(os.path.join(ROOT, "scripts", "make_oodeval.py"),
                tmp_path / "scripts")
    _run([str(tmp_path / "scripts" / "make_oodeval.py")], tmp_path)
    port = tmp_path / "port" / "proc_oodeval"
    _run([os.path.join(ROOT, "scripts", "torch_make_oodeval.py"),
          "--out_root", str(port)], tmp_path)
    jax_root = tmp_path / "datasets" / "proc_oodeval"
    names = sorted(os.listdir(jax_root / "00_base_meshes"))
    assert len(names) == 6
    assert sorted(os.listdir(port / "00_base_meshes")) == names
    for rel in [os.path.join("00_base_meshes", n) for n in names] + [
            "settings.ini"]:
        assert (port / rel).read_bytes() == (jax_root / rel).read_bytes(), rel


def test_sign_error_report_matches_jax(rec_fixture):
    root, ds, res = rec_fixture
    outs = []
    for script, extra in (("sign_error_report.py", []),
                          ("torch_sign_error_report.py",
                           ["--device", "cpu"])):
        cache = root / ("cache_" + script)
        outs.append(_run([os.path.join(ROOT, "scripts", script), str(ds),
                          "testset.txt", str(res), "--cache_dir", str(cache)]
                         + extra, root))
        assert (cache / f"{SHAPE}.npy").is_file()
    jax_lines, port_lines = (o.strip().splitlines() for o in outs)
    assert port_lines == jax_lines
    assert port_lines[1].startswith(SHAPE) and port_lines[-1].startswith(
        "TOTAL")
    rate = float(port_lines[-1].split()[-1].rstrip("%"))
    assert 5.0 < rate < 15.0  # every tenth sign flipped, noise aside


def test_flood_sweep_matches_jax(rec_fixture):
    root, ds, res = rec_fixture
    rows = []
    for script, extra in (("flood_sweep.py", []),
                          ("torch_flood_sweep.py", ["--device", "cpu"])):
        out = root / (script + ".csv")
        _run([os.path.join(ROOT, "scripts", script), "--rec_dir",
              str(res / "rec"), "--gt_dir", str(ds / "03_meshes"),
              "--grid_res", "32", "--seed_filters", "0", "2", "--samples",
              "2000", "--out", str(out)] + extra, root)
        with open(out, newline="") as fh:
            rows.append(list(csv.reader(fh)))
    jax_rows, port_rows = rows
    assert port_rows[0] == jax_rows[0] == [
        "shape", "seed_filter", "sigma", "certainty", "hausdorff", "chamfer",
        "overflow"]
    assert len(port_rows) == len(jax_rows) == 3
    for got, want in zip(port_rows[1:], jax_rows[1:]):
        assert got[:4] == want[:4]
        np.testing.assert_allclose([float(x) for x in got[4:]],
                                   [float(x) for x in want[4:]], rtol=0,
                                   atol=1e-5)
        assert float(got[4]) > 0  # a mesh came out
