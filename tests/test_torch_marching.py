"""Port parity: marching tetrahedra (``ops/marching_cubes.py``, its plain
numpy version, and the C++ copy in ``csrc/marching.cpp`` loaded by
``ops/marching_native.py``).

The numpy version is a copy and must equal JAX's array for array. The
native copy is held against it and against JAX's numpy version as vertex
sets (equal counts, every vertex within 1e-5 of one of the other's), with
equal face counts and a watertight surface. Its output must not depend on
the number of OpenMP threads: runs with 1, 3 and 8 threads are
byte-identical.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

from points2surf_tpu_torch.ops import marching_cubes as tmc
from points2surf_tpu_torch.ops import marching_native as tmn


def _grid(res):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    return np.meshgrid(lin, lin, lin, indexing="ij")


def _sphere(res=24, radius=0.4):
    x, y, z = _grid(res)
    return (radius - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def _plate(res=40):
    x, y, z = _grid(res)
    return np.minimum(0.03 - np.abs(z),
                      0.5 - np.maximum(np.abs(x), np.abs(y))).astype(
        np.float32)


def _blobs(res=28):
    x, y, z = _grid(res)
    return (0.45 - np.sqrt(0.5 * x * x + 1.7 * y * y + 3.1 * z * z)
            + 0.08 * np.sin(4 * x) * np.cos(3 * y)).astype(np.float32)


def _noisy_signs(res=20, seed=0):
    """A clamped sign field like the one sign propagation hands to
    marching: values in {-1, 0, 1} plus small magnitudes near the surface."""
    rng = np.random.RandomState(seed)
    vol = np.clip(_sphere(res, 0.5) * 8.0, -1.0, 1.0)
    vol += rng.randn(*vol.shape).astype(np.float32) * 0.2
    vol = np.clip(vol, -1.0, 1.0)
    vol[0], vol[-1] = -1.0, -1.0
    vol[:, 0], vol[:, -1] = -1.0, -1.0
    vol[:, :, 0], vol[:, :, -1] = -1.0, -1.0
    return vol.astype(np.float32)


FIELDS = {"sphere": _sphere, "plate": _plate, "blobs": _blobs,
          "noisy_signs": _noisy_signs}


def assert_same_vertex_set(a, b, atol):
    """Equal counts, and every vertex of each within atol of the other's."""
    assert a.shape == b.shape
    for p, q in ((a, b), (b, a)):
        dist, _ = cKDTree(q).query(p)
        assert dist.max() <= atol, dist.max()


def assert_watertight(faces):
    """Every undirected edge belongs to exactly two faces."""
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    _, counts = np.unique(np.sort(edges, 1), axis=0, return_counts=True)
    assert (counts == 2).all()


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_numpy_version_equals_jax(field):
    from points2surf_tpu.ops.marching_cubes import marching_tetrahedra

    vol = FIELDS[field]()
    v, f = tmc.marching_tetrahedra(vol, 0.0)
    v_j, f_j = marching_tetrahedra(vol, 0.0)
    assert v.dtype == v_j.dtype and f.dtype == f_j.dtype
    np.testing.assert_array_equal(v, v_j)
    np.testing.assert_array_equal(f, f_j)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_native_matches_numpy_and_jax(field):
    from points2surf_tpu.ops.marching_cubes import marching_tetrahedra

    vol = FIELDS[field]()
    v_n, f_n = tmc.extract_isosurface(vol, 0.0)
    assert v_n.dtype == np.float32 and f_n.dtype == np.int64
    assert len(f_n) > 100
    for v_p, f_p in (tmc.marching_tetrahedra(vol, 0.0),
                     marching_tetrahedra(vol, 0.0)):
        assert len(f_n) == len(f_p)
        assert_same_vertex_set(v_n, v_p, 1e-5)
    assert_watertight(f_n)


@pytest.mark.parametrize("field", ["blobs", "noisy_signs"])
def test_native_order_independent_of_threads(field):
    vol = FIELDS[field]()
    runs = [tmn.marching_tetrahedra(vol, 0.0, threads=t)
            for t in (8, 3, 8, 1)]
    for v, f in runs[1:]:
        assert v.tobytes() == runs[0][0].tobytes()
        assert f.tobytes() == runs[0][1].tobytes()


def test_native_orientation_outward():
    res = 24
    v, f = tmc.extract_isosurface(_sphere(res), 0.0)
    v0, v1, v2 = (v[f[:, k]] for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    outward = np.einsum("ij,ij->i", n, (v0 + v1 + v2) / 3.0 - (res - 1) / 2.0)
    assert (outward > 0).mean() > 0.99


@pytest.mark.parametrize("fill", [-1.0, 1.0])
def test_native_empty_and_full_fields(fill):
    v, f = tmc.extract_isosurface(np.full((8, 8, 8), fill, np.float32), 0.0)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_failed_build_raises_with_log(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tmn.build_library(bad, tmp_path / "build")
