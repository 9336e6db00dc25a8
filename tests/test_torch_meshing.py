"""Port parity: the volume and mesh stage (``infer/meshing.py``) and the mesh
IO it writes with (``utils/mesh_io.py``).

On the CPU, against the JAX package at grid 32 on sphere queries: the volume
of ``_build_volume``, with and without the seed filter, equals JAX's bit for
bit (the sign field is integer and each voxel is splatted at most once);
the debug OFF and the mesh writers give JAX's bytes; meshes match JAX's as
vertex sets within 2e-3 * 2 / GRID with equal face counts. The directory
driver keeps the all-zeros skip, the ``call_necessary`` skip, the flood
warning and the ``P2S_SEED_FILTER`` lever, and, since the port's marching
has a fixed vertex order, matches the single-shape path index for index.
``cuda``-marked tests hold the GPU volume against the CPU volume bit for
bit and write a mesh from the card.
"""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.infer import meshing as tm
from points2surf_tpu_torch.ops import voxel as tv
from points2surf_tpu_torch.utils import mesh_io as tio
from points2surf_tpu_torch.utils import trace

GRID = 32


def _sphere_queries(radius, n_pts=4000, seed=0, grid=GRID, flip=0.0):
    """Grid queries near a sphere and their signed distances (positive
    inside); ``flip`` turns that share of the signs wrong."""
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(n_pts, 3)).astype(np.float32)
    pts *= radius / np.linalg.norm(pts, axis=1, keepdims=True)
    q = tv.grid_query_points(pts, grid, 3, device="cpu")
    dist = (radius - np.linalg.norm(q, axis=1)).astype(np.float32)
    if flip:
        dist[rng.rand(len(dist)) < flip] *= -1.0
    return q.astype(np.float32), dist


def _same_vertex_set(a, b, atol):
    from scipy.spatial import cKDTree

    assert a.shape == b.shape
    for p, q in ((a, b), (b, a)):
        dist, _ = cKDTree(q).query(p)
        assert dist.max() <= atol, dist.max()


@pytest.fixture
def rec_dirs(tmp_path):
    dist_dir = tmp_path / "dist_ms"
    pts_dir = tmp_path / "query_pts_ms"
    dist_dir.mkdir()
    pts_dir.mkdir()
    for name, radius, seed in (("a", 0.4, 1), ("b", 0.55, 2)):
        q, d = _sphere_queries(radius, seed=seed)
        np.save(pts_dir / f"{name}.xyz.npy", q)
        np.save(dist_dir / f"{name}.xyz.npy", d)
    # an all-zeros shape must be skipped with a warning, not crash
    q, _ = _sphere_queries(0.3, seed=7)
    np.save(pts_dir / "zeros.xyz.npy", q)
    np.save(dist_dir / "zeros.xyz.npy", np.zeros(len(q), np.float32))
    return (str(dist_dir), str(pts_dir), str(tmp_path / "vol"),
            str(tmp_path / "mesh"))


@pytest.mark.parametrize("seed_filter,flip", [(0, 0.0), (0, 0.05), (2, 0.05),
                                              (4, 0.05)])
def test_build_volume_matches_jax(seed_filter, flip):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.infer import meshing as jm

    q, d = _sphere_queries(0.45, seed=3, flip=flip)
    with trace.recording() as recording:
        got = tm._build_volume(torch.from_numpy(q), torch.from_numpy(d),
                               len(q), GRID, 5, 13, seed_filter).numpy()
    want = np.asarray(jm._build_volume(jnp.asarray(q), jnp.asarray(d),
                                       len(q), GRID, 5, 13, seed_filter))
    assert got.dtype == np.float32 and got.shape == (GRID,) * 3
    np.testing.assert_array_equal(got, want)
    assert recording["counters"]["volume.rounds"] >= 2
    assert got.min() == -1.0 and got.max() > 0.0


def test_build_volume_ignores_padding_rows():
    q, d = _sphere_queries(0.45, seed=3)
    pad_q = np.concatenate([q, np.repeat(q[:1], 100, 0)])
    pad_d = np.concatenate([d, np.full(100, -5.0, np.float32)])
    got = tm._build_volume(torch.from_numpy(pad_q), torch.from_numpy(pad_d),
                           len(q), GRID, 5, 13)
    want = tm._build_volume(torch.from_numpy(q), torch.from_numpy(d), len(q),
                            GRID, 5, 13)
    assert torch.equal(got, want)


def test_write_debug_volume_byte_identical(tmp_path):
    from points2surf_tpu.infer import meshing as jm

    q, d = _sphere_queries(0.4, n_pts=500, seed=4)
    tm._write_debug_volume(q, d, str(tmp_path / "port.off"))
    jm._write_debug_volume(q, d, str(tmp_path / "jax.off"))
    assert ((tmp_path / "port.off").read_bytes()
            == (tmp_path / "jax.off").read_bytes())


@pytest.mark.parametrize("kind", ["off", "coff", "ply", "ply_ascii",
                                  "ply_cloud"])
def test_mesh_writers_byte_identical(tmp_path, rng, kind):
    from points2surf_tpu.utils import mesh_io as jio

    v = rng.randn(50, 3).astype(np.float32)
    f = rng.randint(0, 50, (80, 3)).astype(np.int64)
    cols = rng.rand(50, 3)
    ext = "off" if kind in ("off", "coff") else "ply"
    paths = [str(tmp_path / f"{who}.{ext}") for who in ("port", "jax")]
    for io, path in zip((tio, jio), paths):
        if kind == "off":
            io.write_off(path, v, f)
        elif kind == "coff":
            io.write_off(path, v, np.array([]), colors_vertex=cols)
        elif kind == "ply":
            io.write_ply(path, v, f)
        elif kind == "ply_ascii":
            io.write_ply(path, v, f, binary=False)
        else:
            io.write_ply(path, v)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    v_t, f_t = tio.load_mesh(paths[0])
    v_j, f_j = jio.load_mesh(paths[1])
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_allclose(v_t, v, rtol=1e-6)
    if kind in ("off", "ply", "ply_ascii"):
        np.testing.assert_array_equal(f_t, f)


def test_implicit_surface_to_mesh_matches_jax(tmp_path, capsys):
    from points2surf_tpu.infer import meshing as jm
    from points2surf_tpu.utils import mesh_io as jio

    q, d = _sphere_queries(0.45, seed=5, flip=0.02)
    assert tm.implicit_surface_to_mesh(
        d, q, str(tmp_path / "t.off"), str(tmp_path / "t.ply"), GRID, 5, 13,
        device="cpu")
    out = capsys.readouterr().out
    assert "Sign propagation took" in out and "Isosurface extraction" in out
    assert jm.implicit_surface_to_mesh(
        d, q, str(tmp_path / "j.off"), str(tmp_path / "j.ply"), GRID, 5, 13)
    v_t, f_t = tio.load_mesh(str(tmp_path / "t.ply"))
    v_j, f_j = jio.load_mesh(str(tmp_path / "j.ply"))
    assert len(f_t) == len(f_j) > 100
    _same_vertex_set(v_t, v_j, 2e-3 * 2.0 / GRID)
    assert ((tmp_path / "t.off").read_bytes()
            == (tmp_path / "j.off").read_bytes())


def test_implicit_surface_to_mesh_file(tmp_path):
    q, d = _sphere_queries(0.45, seed=5)
    np.save(tmp_path / "d.npy", d)
    np.save(tmp_path / "q.npy", q)
    tm.implicit_surface_to_mesh_file(
        str(tmp_path / "d.npy"), str(tmp_path / "q.npy"),
        str(tmp_path / "f.off"), str(tmp_path / "f.ply"), GRID, 5, 13,
        device="cpu")
    assert tm.implicit_surface_to_mesh(
        d, q, str(tmp_path / "o.off"), str(tmp_path / "o.ply"), GRID, 5, 13,
        device="cpu")
    assert (tmp_path / "f.ply").read_bytes() == (tmp_path / "o.ply").read_bytes()
    assert (tmp_path / "f.off").read_bytes() == (tmp_path / "o.off").read_bytes()


def test_implicit_surface_to_mesh_skips_all_zeros(tmp_path, capsys):
    q, _ = _sphere_queries(0.3, seed=7)
    assert not tm.implicit_surface_to_mesh(
        np.zeros(len(q), np.float32), q, str(tmp_path / "z.off"),
        str(tmp_path / "z.ply"), GRID, 5, 13, device="cpu")
    assert "contains only zeros" in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_directory_driver_matches_single_path(rec_dirs, tmp_path, capsys):
    dist_dir, pts_dir, vol_dir, mesh_dir = rec_dirs
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, device="cpu")
    out = capsys.readouterr().out
    assert "contains only zeros" in out
    assert sorted(os.listdir(mesh_dir)) == ["a.ply", "b.ply"]
    assert sorted(os.listdir(vol_dir)) == ["a.off", "b.off"]

    for name, radius in (("a", 0.4), ("b", 0.55)):
        d = np.load(os.path.join(dist_dir, f"{name}.xyz.npy"))
        q = np.load(os.path.join(pts_dir, f"{name}.xyz.npy"))
        assert tm.implicit_surface_to_mesh(
            d, q, str(tmp_path / "o.off"), str(tmp_path / "o.ply"), GRID, 5,
            13, device="cpu")
        v_dir, f_dir = tio.load_mesh(os.path.join(mesh_dir, f"{name}.ply"))
        v_one, f_one = tio.load_mesh(str(tmp_path / "o.ply"))
        # one fixed marching order: index for index
        np.testing.assert_array_equal(v_dir, v_one)
        np.testing.assert_array_equal(f_dir, f_one)
        r = np.linalg.norm(v_dir, axis=1)
        assert abs(np.median(r) - radius) < 2.5 / GRID
        assert (open(os.path.join(vol_dir, f"{name}.off"), "rb").read()
                == (tmp_path / "o.off").read_bytes())


def test_directory_driver_matches_jax_driver(rec_dirs, tmp_path):
    from points2surf_tpu.infer import meshing as jm

    dist_dir, pts_dir, vol_dir, mesh_dir = rec_dirs
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, device="cpu")
    jm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, str(tmp_path / "jvol"), str(tmp_path / "jmesh"),
        GRID, 5, 13)
    assert sorted(os.listdir(tmp_path / "jmesh")) == ["a.ply", "b.ply"]
    for name in ("a", "b"):
        v_t, f_t = tio.load_mesh(os.path.join(mesh_dir, f"{name}.ply"))
        v_j, f_j = tio.load_mesh(str(tmp_path / "jmesh" / f"{name}.ply"))
        assert len(f_t) == len(f_j)
        # JAX's driver fetches the volume in f16: iso-crossings move < 0.002
        # voxel
        _same_vertex_set(v_t, v_j, 2e-3 * 2.0 / GRID)


def test_directory_driver_incremental_skip(rec_dirs, capsys):
    dist_dir, pts_dir, vol_dir, mesh_dir = rec_dirs
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, device="cpu")
    mtimes = {f: os.path.getmtime(os.path.join(mesh_dir, f))
              for f in os.listdir(mesh_dir)}
    assert "Isosurface extraction" in capsys.readouterr().out
    # second run: call_necessary sees fresh outputs and does nothing
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, device="cpu")
    assert "Isosurface extraction" not in capsys.readouterr().out
    for f, m in mtimes.items():
        assert os.path.getmtime(os.path.join(mesh_dir, f)) == m


@pytest.mark.parametrize("index", [0, 1])
def test_directory_driver_shard(rec_dirs, index):
    dist_dir, pts_dir, vol_dir, mesh_dir = rec_dirs
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, shard=(index, 2),
        device="cpu")
    # sorted files a, b, zeros: shard 0 holds a and zeros, shard 1 holds b
    assert os.listdir(mesh_dir) == [["a.ply"], ["b.ply"]][index]


def test_flood_warning_on_overflowing_reconstruction(tmp_path, capsys):
    res = 32
    vol = -np.ones((res, res, res), np.float32)
    vol[4:28, 4:28, 4:28] = 1.0  # big inside blob spanning most of grid
    # queried region is a tiny corner -> blob overflows it
    q = np.array([[-0.9, -0.9, -0.9], [-0.8, -0.8, -0.8]], np.float32)
    assert tm._extract_and_write(vol, str(tmp_path / "m.ply"), res, q)
    assert "sign-propagation flooding" in capsys.readouterr().out
    # queried region covers the blob -> no warning
    q2 = np.array([[-0.95, -0.95, -0.95], [0.95, 0.95, 0.95]], np.float32)
    assert tm._extract_and_write(vol, str(tmp_path / "m2.ply"), res, q2)
    assert "flooding" not in capsys.readouterr().out
    # no 0-level set: nothing written
    assert not tm._extract_and_write(vol * 0 - 1, str(tmp_path / "m3.ply"),
                                     res, q2)
    assert "no 0-level set" in capsys.readouterr().out
    assert not (tmp_path / "m3.ply").exists()


def test_seed_filter_env_lever(rec_dirs, monkeypatch, capsys):
    seen = []
    real = tm._build_volume

    def spy(*a, **k):
        seen.append(a[6] if len(a) > 6 else k.get("seed_filter", 0))
        return real(*a, **k)

    monkeypatch.setattr(tm, "_build_volume", spy)
    dist_dir, pts_dir, vol_dir, mesh_dir = rec_dirs

    monkeypatch.setenv("P2S_SEED_FILTER", "2")
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir, mesh_dir, GRID, 5, 13, device="cpu")
    assert seen and all(s == 2 for s in seen)
    assert "seed_filter=2" in capsys.readouterr().out
    assert sorted(os.listdir(mesh_dir)) == ["a.ply", "b.ply"]

    seen.clear()
    monkeypatch.setenv("P2S_SEED_FILTER", "nope")
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir + "2", mesh_dir + "2", GRID, 5, 13,
        device="cpu")
    assert seen and all(s == 0 for s in seen)
    assert "not an integer" in capsys.readouterr().out

    seen.clear()
    tm.implicit_surface_to_mesh_directory(
        dist_dir, pts_dir, vol_dir + "3", mesh_dir + "3", GRID, 5, 13,
        seed_filter=4, device="cpu")
    assert seen and all(s == 4 for s in seen)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the volume build runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed_filter", [0, 4])
def test_build_volume_gpu_equals_cpu(cuda_device, seed_filter):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    q, d = _sphere_queries(0.45, n_pts=20000, seed=6, grid=64, flip=0.03)
    vols, rounds = [], []
    for dev in (cuda_device, torch.device("cpu")):
        with trace.recording() as recording:
            vols.append(tm._build_volume(
                torch.from_numpy(q).to(dev), torch.from_numpy(d).to(dev),
                len(q), 64, 5, 13, seed_filter).cpu())
        rounds.append(recording["counters"]["volume.rounds"])
    assert torch.equal(vols[0], vols[1])
    assert rounds[0] == rounds[1] >= 2


@pytest.mark.cuda
def test_implicit_surface_to_mesh_on_cuda(cuda_device, tmp_path):
    q, d = _sphere_queries(0.45, seed=5, flip=0.02)
    assert tm.implicit_surface_to_mesh(
        d, q, str(tmp_path / "g.off"), str(tmp_path / "g.ply"), GRID, 5, 13,
        device=cuda_device)
    assert tm.implicit_surface_to_mesh(
        d, q, str(tmp_path / "c.off"), str(tmp_path / "c.ply"), GRID, 5, 13,
        device="cpu")
    assert (tmp_path / "g.ply").read_bytes() == (tmp_path / "c.ply").read_bytes()
    v, f = tio.load_mesh(str(tmp_path / "g.ply"))
    assert len(v) > 100 and len(f) > 100
