"""Port parity: dataset generation (``datagen/``, ``utils/mesh.py``,
``cli/make_dataset.py``) against the JAX package on the CPU.

The same inputs go through both packages: ``scan_poses`` is byte-identical;
the sphere scan of ``tests/test_datagen.py`` (44 x 36 rays) agrees ray for
ray on >= 99.9% of the hit masks, ``t`` and points to 1e-5 where both hit
the same triangle, and hits per scan within the flipped rays; ``Mesh`` and
its helpers are equal bit for bit. A whole ``make_dataset`` run (three
analytic meshes, 3-5 scans at 44 x 36 with noise, 500 queries) is compared
stage by stage: the ``01``-``03`` PLYs, the poses, ``05_query_pts`` and the
split files byte-identical, ``04_pts`` within the scan tolerance,
``05_query_dist`` to 1e-5; a second run is a no-op. The BlenSor merge-back
(``tests/test_datagen.py``'s two cases) and the CLI with ``--procedural 2``
run as well. The ray caster forms the FMAs that XLA's CPU compiler forms
(``ops/raycast.py``); the 99.9% and the 1e-5 leave room for a ray that
grazes an edge or a vertex, where any other rounding flips hit and miss
or moves ``t``. ``cuda``-marked tests hold the card against the CPU.
"""

import configparser
import functools
import gzip
import os
import shutil

import types

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.datagen import blensor as tbl
from points2surf_tpu_torch.datagen import make_dataset as tmk
from points2surf_tpu_torch.datagen import scanner as tsc
from points2surf_tpu_torch.ops import raycast as trc
from points2surf_tpu_torch.ops.marching_cubes import marching_tetrahedra
from points2surf_tpu_torch.utils import mesh as tmesh
from points2surf_tpu_torch.utils import mesh_io

RES = (44, 36)
STAGES_BYTES = ("00_base_meshes", "01_base_meshes_ply", "02_meshes_cleaned",
                "03_meshes", "04_pts_locations", "04_pts_rotations",
                "05_query_pts")
SPLITS = ("trainset.txt", "valset.txt", "testset.txt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the eager ops here are many and small, and the
    suite runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _analytic_mesh(kind, res=24):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    if kind == "sphere":
        vol = 0.5 - np.sqrt(x * x + y * y + z * z)
    elif kind == "box":
        vol = 0.4 - np.abs(np.stack([x, y, z])).max(axis=0)
    else:  # ellipsoid
        vol = 0.5 - np.sqrt(x * x + (y / 0.6) ** 2 + (z / 0.8) ** 2)
    v, f = marching_tetrahedra(vol.astype(np.float32), 0.0)
    v = v / (res - 1) * 2.0 - 1.0
    return v.astype(np.float32), f


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, so that the ``cuda`` tests
    also run where jax is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.cli import make_dataset as cli
    from points2surf_tpu.datagen import blensor, make_dataset, scanner
    from points2surf_tpu.ops import raycast
    from points2surf_tpu.utils import mesh

    return types.SimpleNamespace(jnp=jnp, cli=cli, bl=blensor,
                                 mk=make_dataset, sc=scanner, rc=raycast,
                                 mesh=mesh)


def _small_scans(monkeypatch, *modules):
    """The scanners of ``modules`` at 44 x 36 rays (``sample_scans`` looks
    the function up on the module at each call)."""
    for mod in modules:
        monkeypatch.setattr(mod, "scan_mesh", functools.partial(
            mod.scan_mesh, res_x=RES[0], res_y=RES[1]))


def _write_raw_dataset(base, kinds=("sphere", "box", "ellipsoid"),
                       sigma_max=0.02):
    os.makedirs(os.path.join(base, "ds", "00_base_meshes"))
    for kind in kinds:
        v, f = _analytic_mesh(kind)
        mesh_io.write_off(
            os.path.join(base, "ds", "00_base_meshes", kind + ".off"), v, f)
    cfg = configparser.ConfigParser()
    cfg["general"] = {
        "only_for_evaluation": "0", "grid_resolution": "64", "epsilon": "3",
        "num_scans_per_mesh_min": "3", "num_scans_per_mesh_max": "5",
        "scanner_noise_sigma_min": "0.0",
        "scanner_noise_sigma_max": str(sigma_max),
    }
    with open(os.path.join(base, "ds", "settings.ini"), "w") as f:
        cfg.write(f)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _scan_rays(loc, quat, res=RES):
    rot = tsc._quat_to_rotmat_np(quat)
    dirs = (tsc._frustum_dirs(*res) @ rot).astype(np.float32)
    origin = (rot.T @ (-loc)).astype(np.float32)
    return np.broadcast_to(origin, dirs.shape).copy(), dirs


def _per_ray(jx, v, f, loc, quat):
    """(t, tri_id) of one scan's rays in JAX and in the port."""
    o, d = _scan_rays(loc, quat)
    t_j, id_j = jx.rc.raycast_padded(jx.jnp.asarray(o), jx.jnp.asarray(d),
                                     *jx.rc.pad_triangles(v, f))
    t_t, id_t = trc.raycast_padded(torch.as_tensor(o), torch.as_tensor(d),
                                   *trc.pad_triangles(v, f, device="cpu"))
    return (np.asarray(t_j), np.asarray(id_j)), (t_t.numpy(), id_t.numpy())


def _hit(t):
    return np.isfinite(t) & (t <= tsc.MAX_DISTANCE)


def assert_scans_match(jx, v, f, locs, rots, out_j, out_t):
    """scan_mesh outputs (points, normals, hits) of both packages: per scan,
    the rays both hit within 1e-5, the hit counts within the flips."""
    (p_j, n_j, h_j), (p_t, n_t, h_t) = out_j, out_t
    o_j = o_t = 0
    flips = 0
    for k, (loc, quat) in enumerate(zip(locs, rots)):
        (t_j, id_j), (t_t, id_t) = _per_ray(jx, v, f, loc, quat)
        m_j, m_t = _hit(t_j), _hit(t_t)
        assert h_j[k] == m_j.sum() and h_t[k] == m_t.sum()
        flip = int((m_j != m_t).sum())
        flips += flip
        assert abs(h_j[k] - h_t[k]) <= flip
        both = m_j & m_t
        same = both & (id_j == id_t)
        np.testing.assert_allclose(t_t[same], t_j[same], rtol=0, atol=1e-5)
        rows_j = o_j + np.cumsum(m_j)[both] - 1
        rows_t = o_t + np.cumsum(m_t)[both] - 1
        np.testing.assert_allclose(p_t[rows_t], p_j[rows_j], rtol=0,
                                   atol=1e-5)
        tri_same = (id_j == id_t)[both]
        np.testing.assert_array_equal(n_t[rows_t][tri_same],
                                      n_j[rows_j][tri_same])
        assert tri_same.mean() >= 0.999
        o_j += h_j[k]
        o_t += h_t[k]
    assert (o_j, o_t) == (len(p_j), len(p_t))
    assert flips <= 0.001 * len(locs) * RES[0] * RES[1]


@pytest.mark.parametrize("name", ["dummy.ply", "x/mesh_01.ply",
                                  "00011084_fddd53ce45f640f3ab922328_"
                                  "trimesh_019.ply"])
def test_scan_poses_byte_identical(name, jx):
    for args in ((3, 5, 0.0, 0.02), (5, 30, 0.0, 0.05)):
        want = jx.sc.scan_poses(name, *args)
        got = tsc.scan_poses(name, *args)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()
        assert got[2] == want[2]


def test_sphere_scan_matches_jax(jx):
    v, f = _analytic_mesh("sphere")
    locs, rots, _ = tsc.scan_poses("dummy.ply", 3, 5, 0.0, 0.02)
    mj, mt = jx.mesh.Mesh(v, f), tmesh.Mesh(v, f)
    for sigma, seed in ((0.0, 0), (0.01, 7)):
        out_j = jx.sc.scan_mesh(mj, locs, rots, sigma, seed=seed,
                                res_x=RES[0], res_y=RES[1])
        out_t = tsc.scan_mesh(mt, locs, rots, sigma, seed=seed,
                              res_x=RES[0], res_y=RES[1], device="cpu")
        assert out_t[0].dtype == np.float32 and out_t[1].dtype == np.float32
        assert sum(out_t[2]) > 200
        assert_scans_match(jx, v, f, locs, rots, out_j, out_t)


def _messy_mesh():
    """The marched sphere with duplicated vertices, a degenerate face, a
    rotated duplicate face and inverted orientation."""
    v, f = _analytic_mesh("sphere", res=16)
    f = f[:, ::-1].copy()
    n = len(v)
    v = np.concatenate([v, v[:40]])
    f[::7] = np.where(f[::7] < 40, f[::7] + n, f[::7])
    f = np.concatenate([f, [[0, 0, 5]], f[3:4, [1, 2, 0]]])
    return v.astype(np.float32), f.astype(np.int64)


def test_mesh_matches_jax(jx):
    v, f = _messy_mesh()
    mj, mt = jx.mesh.Mesh(v, f), tmesh.Mesh(v, f)
    assert mt.is_watertight() == mj.is_watertight()
    cj, ct = mj.cleaned(), mt.cleaned()
    for a, b in ((cj, ct), (cj.fixed_inversion(), ct.fixed_inversion()),
                 (cj.normalized_unit_cube(0.1),
                  ct.normalized_unit_cube(0.1))):
        assert b.vertices.tobytes() == a.vertices.tobytes()
        assert b.faces.tobytes() == a.faces.tobytes()
    assert ct.is_watertight() and ct.is_watertight() == cj.is_watertight()
    assert ct.volume < 0 < ct.fixed_inversion().volume
    assert ct.volume == cj.volume
    assert ct.face_normals.tobytes() == cj.face_normals.tobytes()
    assert ct.face_areas.tobytes() == cj.face_areas.tobytes()
    for lo_hi in zip(ct.bounds(), cj.bounds()):
        np.testing.assert_array_equal(*lo_hi)
    s_j = cj.sample_surface(1000, np.random.RandomState(3))
    s_t = ct.sample_surface(1000, np.random.RandomState(3))
    assert s_t[0].tobytes() == s_j[0].tobytes()
    np.testing.assert_array_equal(s_t[1], s_j[1])
    a_j, a_t = jx.mesh.vertex_adjacency(cj), tmesh.vertex_adjacency(ct)
    for attr in ("indptr", "indices", "data"):
        assert getattr(a_t, attr).tobytes() == getattr(a_j, attr).tobytes()


@pytest.fixture(scope="module")
def generated(tmp_path_factory, jx):
    """The same raw dataset through both packages' make_dataset."""
    root = str(tmp_path_factory.mktemp("mkds"))
    mp = pytest.MonkeyPatch()
    _small_scans(mp, jx.sc, tsc)
    try:
        for pkg, mod, kw in (("jax", jx.mk, {}), ("torch", tmk,
                                                  {"device": "cpu"})):
            base = os.path.join(root, pkg)
            _write_raw_dataset(base)
            mod.make_dataset("ds", base_dir=base, num_processes=1,
                             num_query_pts=500, **kw)
    finally:
        mp.undo()
    return os.path.join(root, "jax", "ds"), os.path.join(root, "torch", "ds")


def test_make_dataset_stages_match_jax(generated):
    ds_j, ds_t = generated
    for stage in STAGES_BYTES:
        files = sorted(os.listdir(os.path.join(ds_j, stage)))
        assert len(files) == 3, stage
        assert sorted(os.listdir(os.path.join(ds_t, stage))) == files
        for f in files:
            assert _same_bytes(os.path.join(ds_j, stage, f),
                               os.path.join(ds_t, stage, f)), (stage, f)
    for split in SPLITS:
        assert _same_bytes(os.path.join(ds_j, split),
                           os.path.join(ds_t, split)), split
    for f in sorted(os.listdir(os.path.join(ds_j, "05_query_dist"))):
        d_j = np.load(os.path.join(ds_j, "05_query_dist", f))
        d_t = np.load(os.path.join(ds_t, "05_query_dist", f))
        assert d_t.dtype == np.float32 and d_t.shape == (500,)
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
        assert (np.sign(d_t) == np.sign(d_j)).all()


def test_make_dataset_scans_match_jax(generated, jx):
    ds_j, ds_t = generated
    for f in sorted(os.listdir(os.path.join(ds_t, "03_meshes"))):
        stem = f[:-4]
        v, faces = mesh_io.load_mesh(os.path.join(ds_t, "03_meshes", f))
        locs = np.load(os.path.join(ds_t, "04_pts_locations",
                                    stem + ".npz"))["locations"]
        rots = np.load(os.path.join(ds_t, "04_pts_rotations",
                                    stem + ".npz"))["rotations"]
        outs = []
        for ds in (ds_j, ds_t):
            pts = np.load(os.path.join(ds, "04_pts", stem + ".xyz.npy"))
            assert pts.dtype == np.float32 and pts.shape[1] == 6
            hits = np.load(os.path.join(ds, "04_hits_per_scan",
                                        stem + ".npz"))["hits_per_scan"]
            outs.append((pts[:, :3], pts[:, 3:], list(hits)))
        assert_scans_match(jx, v, faces, locs, rots, *outs)


def test_make_dataset_rerun_is_noop(generated, monkeypatch):
    _, ds_t = generated
    _small_scans(monkeypatch, tsc)
    stamps = {}
    for root, _, files in os.walk(ds_t):
        for f in files:
            p = os.path.join(root, f)
            stamps[p] = os.path.getmtime(p)
    tmk.make_dataset("ds", base_dir=os.path.dirname(ds_t), num_processes=1,
                     num_query_pts=500, device="cpu")
    for p, m in stamps.items():
        if os.path.basename(p) not in SPLITS:
            assert os.path.getmtime(p) == m, p


def test_make_dataset_checks_device_first(tmp_path, monkeypatch):
    """make_dataset defaults to the card and raises before any stage when
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_raw_dataset(str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        tmk.make_dataset("ds", base_dir=str(tmp_path), num_processes=1)
    assert not os.path.exists(tmp_path / "ds" / "01_base_meshes_ply")


def test_reconstruct_gt_matches_jax(generated, tmp_path, jx):
    """The GT round trip of the sphere at grid 32 in both packages: the
    same mesh, as vertex sets (the two marchers order vertices
    differently)."""
    from scipy.spatial import cKDTree

    ds_j, ds_t = generated
    out = {}
    for pkg, ds, mod, kw in (("jax", ds_j, jx.mk, {}),
                             ("torch", ds_t, tmk, {"device": "cpu"})):
        base = tmp_path / pkg
        os.makedirs(base / "ds" / "03_meshes")
        shutil.copy(os.path.join(ds, "03_meshes", "sphere.ply"),
                    base / "ds" / "03_meshes")
        mod.reconstruct_gt(str(base), "ds", grid_resolution=32,
                           num_query_pts=5000, **kw)
        out[pkg] = mesh_io.load_mesh(
            str(base / "ds" / "06_reconstruction_gt" / "sphere.ply"))
    (v_j, f_j), (v_t, f_t) = out["jax"], out["torch"]
    assert len(f_t) == len(f_j) > 0 and v_t.shape == v_j.shape
    for a, b in ((v_j, v_t), (v_t, v_j)):
        assert cKDTree(b).query(a)[0].max() <= 1e-4


def test_cli_procedural_matches_jax(tmp_path, monkeypatch, jx):
    """cli/make_dataset.main with --procedural 2 (plus one analytic mesh,
    since the splits need three shapes) on the CPU, against the JAX CLI."""
    from points2surf_tpu_torch.cli import make_dataset as tcli

    _small_scans(monkeypatch, jx.sc, tsc)
    args = ["--name", "ds", "--num_query_pts", "300", "--procedural", "2",
            "--procedural_seed", "5", "--procedural_styles", "hull", "bumpy"]
    for pkg, main, kw in (("jax", jx.cli.main, {}),
                          ("torch", tcli.main, {"device": "cpu"})):
        base = tmp_path / pkg
        _write_raw_dataset(str(base), kinds=("box",))
        main(args + ["--base_dir", str(base), "--workers", "1"], **kw)
    ds_j, ds_t = tmp_path / "jax" / "ds", tmp_path / "torch" / "ds"
    for stage in STAGES_BYTES:
        files = sorted(os.listdir(ds_j / stage))
        assert len(files) == 3 and sorted(os.listdir(ds_t / stage)) == files
        for f in files:
            assert _same_bytes(ds_j / stage / f, ds_t / stage / f), f
    for split in SPLITS:
        assert _same_bytes(ds_j / split, ds_t / split)
    for f in files:
        np.testing.assert_allclose(np.load(ds_t / "05_query_dist" / f),
                                   np.load(ds_j / "05_query_dist" / f),
                                   rtol=0, atol=1e-5)
        assert (ds_t / "04_pts" / (f[:-8] + ".xyz.npy")).is_file()


# ------------------------------------------------------------- BlenSor ----


def _blensor_scans(tmp_path, mesh, mesh_file, rng, n_pts=40):
    """Synthetic BlenSor scan files of known model-space surface points
    (tests/test_datagen.py's round trip)."""
    locations, rotations, _ = tsc.scan_poses(mesh_file, 2, 3, 0.0, 0.0)
    pts_ms, _ = mesh.sample_surface(n_pts, rng)
    files = []
    for i, (loc, quat) in enumerate(zip(locations, rotations)):
        world = pts_ms @ tsc._quat_to_rotmat_np(quat).T + loc
        vs = np.stack([world[:, 0], world[:, 2], -world[:, 1]], axis=1)
        raw = np.zeros((len(vs) + 1, 16), np.float32)
        raw[:-1, 3] = 1.0
        raw[:-1, 5:8] = vs
        raw[:-1, 8:11] = vs
        path = str(tmp_path / f"scan_{i:05d}00000.numpy.gz")
        with gzip.GzipFile(path, "w") as fh:
            np.savetxt(fh, raw)
        files.append(path)
    return files, list(locations), list(rotations), pts_ms


def test_blensor_merge_back_matches_jax(tmp_path, jx):
    v, f = _analytic_mesh("sphere")
    mesh_file = str(tmp_path / "shape.ply")
    mesh_io.write_ply(mesh_file, v, f)
    files, locs, rots, pts_ms = _blensor_scans(
        tmp_path, tmesh.Mesh(v, f), mesh_file, np.random.RandomState(0))
    merged = {}
    for pkg, fn, kw in (("jax", jx.bl.pcd_files_to_pts, {}),
                        ("torch", tbl.pcd_files_to_pts, {"device": "cpu"})):
        out = tmp_path / pkg
        os.makedirs(out)
        assert fn(files, mesh_file, str(out / "shape.xyz.npz"),
                  str(out / "04_pts" / "shape.xyz.npy"),
                  str(out / "shape.xyz.ply"), locs, rots,
                  str(out / "shape_hits.npz"), **kw)
        merged[pkg] = np.load(out / "04_pts" / "shape.xyz.npy")
        hits = np.load(out / "shape_hits.npz")["hits_per_scan"]
        assert (hits == 40).all()
    got, want = merged["torch"], merged["jax"]
    assert got.shape == (40 * len(files), 6)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, :3], np.tile(pts_ms, (len(files), 1)),
                               atol=1e-4)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=0, atol=1e-6)
    radial = got[:, :3] / np.linalg.norm(got[:, :3], axis=1, keepdims=True)
    assert np.abs(np.sum(got[:, 3:] * radial, axis=1)).min() > 0.8
    assert _same_bytes(tmp_path / "torch" / "shape.xyz.npz",
                       tmp_path / "jax" / "shape.xyz.npz")


def test_blensor_scripts_and_missing_scan_pairing(tmp_path, monkeypatch,
                                                  jx):
    """Scripts equal JAX's; a missing scan drops its own pose
    (tests/test_datagen.py's pairing case, through the port)."""
    v, f = _analytic_mesh("sphere")
    dir_in = tmp_path / "ds" / "03_meshes"
    os.makedirs(dir_in)
    mesh_io.write_ply(str(dir_in / "shape.ply"), v, f)
    locations, rotations, _ = tsc.scan_poses(str(dir_in / "shape.ply"),
                                              4, 4, 0.0, 0.0)
    scripts = {}
    for pkg, mod in (("jax", jx.bl), ("torch", tbl)):
        out = mod.write_blensor_scripts(str(tmp_path), "ds", "03_meshes",
                                        "04_pcd", f"scripts_{pkg}",
                                        4, 4, 0.0, 0.0)
        assert [o[2:] for o in out] == [("shape", 4)]
        with open(out[0][0]) as fh:
            scripts[pkg] = fh.read().replace(f"scripts_{pkg}", "")
    assert scripts["torch"] == scripts["jax"]

    pcd_dir = tmp_path / "ds" / "04_pcd"
    rng = np.random.RandomState(1)
    present = [0, 2, 3]
    for i in present:
        raw = np.zeros((3, 16), np.float32)
        raw[:, 3] = 1.0
        raw[:, 5:8] = raw[:, 8:11] = rng.rand(3, 3)
        with gzip.GzipFile(str(pcd_dir / f"shape_{i:05d}00000.numpy.gz"),
                           "w") as fh:
            np.savetxt(fh, raw)
    captured = {}

    def fake_merge(pcd_files, mesh_file, raw, npy, vis, locs, rots, hits,
                   min_pts_size, device):
        captured.update(files=list(pcd_files), locs=list(locs),
                        rots=list(rots), device=device)
        return True

    monkeypatch.setattr(tbl, "pcd_files_to_pts", fake_merge)
    monkeypatch.setattr(tbl, "run_blensor", lambda *a, **k: [])
    tbl.sample_blensor(str(tmp_path), "ds", "blender", "03_meshes", "04_pts",
                       "04_pts_vis", 4, 4, 0.0, 0.0, num_processes=1,
                       device="cpu")
    assert captured["device"] == "cpu" and len(captured["files"]) == 3
    for j, i in enumerate(present):
        assert f"{i:05d}00000" in os.path.basename(captured["files"][j])
        np.testing.assert_array_equal(captured["locs"][j], locations[i])
        np.testing.assert_array_equal(captured["rots"][j], rotations[i])


# ---------------------------------------------------------------- card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scan_cuda_matches_cpu(cuda_device):
    v, f = _analytic_mesh("sphere")
    mesh = tmesh.Mesh(v, f)
    locs, rots, _ = tsc.scan_poses("dummy.ply", 3, 5, 0.0, 0.02)
    p_c, n_c, h_c = tsc.scan_mesh(mesh, locs, rots, 0.01, seed=3,
                                  device="cpu")
    p_g, n_g, h_g = tsc.scan_mesh(mesh, locs, rots, 0.01, seed=3,
                                  device=cuda_device)
    rays = tsc.TOF_RES_X * tsc.TOF_RES_Y
    assert sum(abs(a - b) for a, b in zip(h_c, h_g)) <= 0.001 * rays
    if h_c == h_g:
        np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-5)
        assert (np.abs(n_g - n_c).max(axis=1) > 1e-6).mean() <= 0.001


@pytest.mark.cuda
def test_make_dataset_cuda_matches_cpu(cuda_device, tmp_path, monkeypatch):
    _small_scans(monkeypatch, tsc)
    for dev in ("cpu", cuda_device):
        base = str(tmp_path / str(dev))
        _write_raw_dataset(base)
        tmk.make_dataset("ds", base_dir=base, num_processes=2,
                         num_query_pts=500, device=dev)
    ds_c, ds_g = tmp_path / "cpu" / "ds", tmp_path / "cuda" / "ds"
    for f in sorted(os.listdir(ds_c / "05_query_pts")):
        assert _same_bytes(ds_c / "05_query_pts" / f,
                           ds_g / "05_query_pts" / f)
        np.testing.assert_allclose(np.load(ds_g / "05_query_dist" / f),
                                   np.load(ds_c / "05_query_dist" / f),
                                   rtol=0, atol=1e-5)
