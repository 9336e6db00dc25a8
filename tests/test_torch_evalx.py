"""Port parity: the host tools beside dataset generation, against the JAX
package on the CPU: ``evalx/metrics.compare_predictions_binary`` and
``visualize_patch``, ``evalx/baselines`` (``get_pts_normals`` on the
device's closest-point op, the meshlab filter calls, the AtlasNet revert),
``evalx/figures`` (``colorize``, the distance-coloured mesh),
``datagen/make_pc_dataset``, ``datagen/synthetic`` and the DeepSDF export
(``datagen/deepsdf``, whose reconstruction samples are signed on the
device). Host-only outputs are byte-identical; what goes through the
device ops holds to their tolerance (``tests/test_torch_meshdist.py``).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from points2surf_tpu.datagen import deepsdf as jds  # noqa: E402
from points2surf_tpu.datagen import make_pc_dataset as jpc
from points2surf_tpu.datagen import synthetic as jsy
from points2surf_tpu.datagen.procedural import icosphere
from points2surf_tpu.evalx import baselines as jbase
from points2surf_tpu.evalx import figures as jfig
from points2surf_tpu.evalx import metrics as jmet
from points2surf_tpu_torch.datagen import deepsdf as tds
from points2surf_tpu_torch.datagen import make_pc_dataset as tpc
from points2surf_tpu_torch.datagen import synthetic as tsy
from points2surf_tpu_torch.evalx import baselines as tbase
from points2surf_tpu_torch.evalx import figures as tfig
from points2surf_tpu_torch.evalx import metrics as tmet
from points2surf_tpu_torch.utils import mesh_io


def _sphere(radius=0.5, subdiv=2):
    v, f = icosphere(subdivisions=subdiv)
    return (v * radius).astype(np.float32), f


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kind", ["mixed", "all_negative", "empty"])
def test_compare_predictions_binary_matches_jax(kind):
    rng = np.random.RandomState(3)
    if kind == "empty":
        gt, pr = np.zeros(0), np.zeros(0)
    else:
        gt, pr = rng.randn(2, 200)
        if kind == "all_negative":
            gt, pr = -np.abs(gt), -np.abs(pr)
    want = jmet.compare_predictions_binary(gt, pr, "cmp")
    got = tmet.compare_predictions_binary(gt, pr, "cmp")
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
    with pytest.raises(ValueError):
        tmet.compare_predictions_binary(np.zeros(3), np.zeros(4))


def test_visualize_patch_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    patch = rng.rand(30, 3).astype(np.float32)
    q_ps = np.zeros(3, np.float32)
    patch[-5:] = q_ps  # padding rows equal to the query are dropped
    sub = rng.rand(50, 3).astype(np.float32)
    q_ms = rng.rand(3).astype(np.float32)
    patch_ms = np.concatenate([rng.rand(20, 3), np.tile(q_ms, (4, 1))])
    for extra in (None, patch_ms):
        files = []
        for mod in (jmet, tmet):
            p = str(tmp_path / f"{mod.__name__}.ply")
            mod.visualize_patch(patch, q_ps, sub, q_ms, p, extra)
            files.append(p)
        with open(files[0], "rb") as a, open(files[1], "rb") as b:
            assert a.read() == b.read()


def _normals_dataset(root, rng):
    v, f = _sphere()
    ds = root / "ds"
    (ds / "04_pts").mkdir(parents=True)
    (ds / "03_meshes").mkdir()
    mesh_io.write_ply(str(ds / "03_meshes" / "s.ply"), v, f)
    dirs = rng.randn(100, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.save(ds / "04_pts" / "s.xyz.npy",
            (dirs * rng.uniform(0.45, 0.55, (100, 1))).astype(np.float32))


def test_get_pts_normals_matches_jax(tmp_path):
    for pkg, mod, kw in (("jax", jbase, {}), ("torch", tbase,
                                             {"device": "cpu"})):
        _normals_dataset(tmp_path / pkg, np.random.RandomState(7))
        mod.get_pts_normals(str(tmp_path / pkg), "ds", "04_pts", "03_meshes",
                            "06_normals", **kw)
    out = [tmp_path / pkg / "ds" / "06_normals" for pkg in ("jax", "torch")]
    n_j, n_t = (np.load(d / "s.xyz.npy") for d in out)
    assert n_t.shape == (100, 3) and n_t.dtype == np.float32
    np.testing.assert_array_equal(n_t, n_j)
    assert (out[1] / "pts" / "s.xyz").read_bytes() == \
        (out[0] / "pts" / "s.xyz").read_bytes()
    m = os.path.getmtime(out[1] / "s.xyz.npy")
    tbase.get_pts_normals(str(tmp_path / "torch"), "ds", "04_pts",
                          "03_meshes", "06_normals", device="cpu")
    assert os.path.getmtime(out[1] / "s.xyz.npy") == m


def test_meshlab_filter_calls_and_atlasnet_revert(tmp_path, monkeypatch):
    """The external-tool commands are JAX's; the AtlasNet revert equal."""
    (tmp_path / "ds" / "in").mkdir(parents=True)
    for name in ("a.xyz", "b.ply"):
        (tmp_path / "ds" / "in" / name).write_text("0 0 0\n")
    calls = {}
    for pkg, mod in (("jax", jbase), ("torch", tbase)):
        monkeypatch.setattr(mod, "start_process_pool",
                            lambda fn, c, n, pkg=pkg: calls.setdefault(pkg, c))
        mod.apply_meshlab_filter(str(tmp_path), "ds", "in", f"out_{pkg}", 2,
                                 "f.mlx", "meshlabserver")
        mod.write_filter_scripts(str(tmp_path / f"mlx_{pkg}"))
    assert [c[0].replace("out_torch", "out_jax") for c in calls["torch"]] == \
        [c[0] for c in calls["jax"]]
    assert _tree_bytes(tmp_path / "mlx_torch") == \
        _tree_bytes(tmp_path / "mlx_jax")

    rng = np.random.RandomState(8)
    pts_file = str(tmp_path / "cloud.xyz.npy")
    np.save(pts_file, (rng.rand(500, 3) * 3 + 5).astype(np.float32))
    verts = rng.rand(40, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tbase.revert_atlasnet_transform(verts, pts_file),
        jbase.revert_atlasnet_transform(verts, pts_file))


def test_figures_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    vals = rng.rand(300) * 3 - 1
    for vmin, vmax in ((None, None), (0.0, 1.0)):
        np.testing.assert_array_equal(tfig.colorize(vals, vmin, vmax),
                                      jfig.colorize(vals, vmin, vmax))
    np.testing.assert_array_equal(tfig.parula_colormap(64),
                                  jfig.parula_colormap(64))
    v, f = _sphere()
    mesh_io.write_ply(str(tmp_path / "ref.ply"), v, f)
    mesh_io.write_ply(str(tmp_path / "new.ply"), v * 1.1, f)
    got = [mod.visualize_mesh_with_distances(
        str(tmp_path / "new.ply"), str(tmp_path / "ref.ply"),
        str(tmp_path / f"{name}.ply"), samples_per_model=2000)
        for name, mod in (("jax", jfig), ("torch", tfig))]
    assert got[0] == got[1]
    assert (tmp_path / "torch.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_make_pc_dataset_matches_jax(tmp_path):
    for pkg, mod in (("jax", jpc), ("torch", tpc)):
        rng = np.random.RandomState(7)
        raw = tmp_path / pkg / "pcds" / "00_base_pc"
        raw.mkdir(parents=True)
        np.save(raw / "a.npy", (rng.rand(3000, 3) * 4 + 10).astype(np.float32))
        mesh_io.write_xyz(str(raw / "b.xyz"),
                          rng.rand(50, 3).astype(np.float32))
        mod.make_pc_dataset("pcds", base_dir=str(tmp_path / pkg),
                            target_num_points=1000)
    got = _tree_bytes(tmp_path / "torch")
    assert got == _tree_bytes(tmp_path / "jax")
    assert {"pcds/04_pts/a.xyz.npy", "pcds/testset.txt"} <= set(got)


def test_synthetic_dataset_matches_jax(tmp_path):
    for pkg, mod in (("jax", jsy), ("torch", tsy)):
        mod.make_synthetic_dataset(str(tmp_path / pkg),
                                   shapes=("sphere", "box", "torus"),
                                   n_points=500, n_query=300,
                                   noise_sigma=0.01, seed=2)
    got = _tree_bytes(tmp_path / "torch")
    assert got == _tree_bytes(tmp_path / "jax") and len(got) == 15


def _deepsdf_dataset(root, rng):
    """tests/test_evalx.py's mini dataset: 't' trains on GT samples, 's' is
    reconstructed from its scan."""
    ds = root / "mini"
    for sub in ("04_pts", "05_query_pts", "05_query_dist", "03_meshes"):
        (ds / sub).mkdir(parents=True)
    v, f = _sphere()
    for stem in ("s", "t"):
        mesh_io.write_ply(str(ds / "03_meshes" / f"{stem}.ply"), v, f)
        dirs = rng.randn(50, 3)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        np.save(ds / "04_pts" / f"{stem}.xyz.npy",
                np.concatenate([0.5 * dirs, dirs], axis=1).astype(np.float32))
        q = rng.rand(30, 3).astype(np.float32) - 0.5
        np.save(ds / "05_query_pts" / f"{stem}.ply.npy", q)
        np.save(ds / "05_query_dist" / f"{stem}.ply.npy",
                (0.5 - np.linalg.norm(q, axis=1)).astype(np.float32))
    (ds / "trainset.txt").write_text("t\n")
    (ds / "testset.txt").write_text("s\n")


def test_deepsdf_export_matches_jax(tmp_path):
    for pkg, mod, kw in (("jax", jds, {}), ("torch", tds, {"device": "cpu"})):
        _deepsdf_dataset(tmp_path / pkg, np.random.RandomState(5))
        shapes = mod.export_for_deepsdf(str(tmp_path / pkg), "mini",
                                        str(tmp_path / pkg / "out"), **kw)
        assert shapes == ["s", "t"]
    out_j, out_t = tmp_path / "jax" / "out", tmp_path / "torch" / "out"
    files_j, files_t = _tree_bytes(out_j), _tree_bytes(out_t)
    assert sorted(files_t) == sorted(files_j)
    sdf = os.path.join("SdfSamples", "mini", "all")
    for name, data in files_t.items():
        if name != os.path.join(sdf, "s.npz"):
            assert data == files_j[name], name
    # the scan-synthesized samples: near pairs exact, far samples signed on
    # the device
    z_j, z_t = (np.load(d / sdf / "s.npz") for d in (out_j, out_t))
    assert z_t.files == z_j.files
    for k in ("pos", "neg"):
        np.testing.assert_array_equal(z_t[k], z_j[k])
    for k in ("pos_far", "neg_far"):
        assert z_t[k].shape == z_j[k].shape
        np.testing.assert_array_equal(z_t[k][:, :3], z_j[k][:, :3])
        np.testing.assert_allclose(z_t[k][:, 3], z_j[k][:, 3], rtol=0,
                                   atol=1e-5)
    with open(out_t / "splits" / "mini_test.json") as fh:
        assert json.load(fh) == {"mini": {"all": ["s"]}}
