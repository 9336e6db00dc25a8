"""Port parity: the device ops of dataset generation, ``ops/meshdist.py``
(signed distance with the winding number, exact closest point) and
``ops/raycast.py`` (Möller–Trumbore), against the JAX package on the CPU.

The cases are ``tests/test_meshdist.py``'s (a marched sphere, a cube's
corners, a sphere's near-surface field, the closest-point sphere), with the
same queries through both packages. Distances and closest points hold to
atol 1e-5, winding numbers to 1e-4. Face ids are equal except at exact
ties: where they differ, both faces lie at the same float64 distance from
the query (a shared vertex or edge), and the packages' fp32 rounding picks
a different first index. The port also meets the trimesh ground truth
bundled with ``abc_minimal`` (``05_query_dist``, clipped to [-1, 1]) on its
2,872-face mesh: 1e-4, every sign. ``cuda``-marked tests hold the card
against the CPU.
"""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import meshdist as tm
from points2surf_tpu_torch.ops import raycast as tr
from points2surf_tpu_torch.ops.marching_cubes import marching_tetrahedra
from points2surf_tpu_torch.utils import mesh_io

ROOT = os.path.join(os.path.dirname(__file__), "..")
ABC = os.path.join(ROOT, "datasets", "abc_minimal")
ABC_SMALL = "00994122_57d9d4755722f9d2d7436f0a_trimesh_000.ply"


def _sphere_mesh(res, radius):
    lin = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = radius - np.sqrt(x * x + y * y + z * z)
    v, f = marching_tetrahedra(vol.astype(np.float32), 0.0)
    return (v / (res - 1) * 2.0 - 1.0).astype(np.float32), f


def _cube_mesh(hv=0.4):
    corners = np.array(
        [[x, y, z] for x in (-hv, hv) for y in (-hv, hv) for z in (-hv, hv)],
        np.float32,
    )
    quads = [(0, 1, 3, 2, False), (4, 5, 7, 6, True), (0, 1, 5, 4, True),
             (2, 3, 7, 6, False), (0, 2, 6, 4, False), (1, 3, 7, 5, True)]
    faces = []
    for a, b, c, d, flip in quads:
        faces += [(a, b, c), (a, c, d)] if flip else [(a, c, b), (a, d, c)]
    return corners, np.asarray(faces, np.int64)


def _case(name):
    """(vertices, faces, queries, query_batch, tri_chunk) of a case of
    tests/test_meshdist.py."""
    rng = np.random.RandomState(0)
    if name == "sphere":
        v, f = _sphere_mesh(28, 0.5)
        q = (rng.rand(500, 3).astype(np.float32) * 1.6) - 0.8
        return v, f, q, 256, 512
    if name == "cube_corners":
        v, f = _cube_mesh()
        q = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.5, 0.0, 0.0],
                      [0.5, 0.5, 0.5]], np.float32)
        return v, f, q, 4, 16
    if name == "grid_field":
        v, f = _sphere_mesh(36, 0.45)
        base = v[rng.choice(len(v), 64)]
        normal_dir = base / np.linalg.norm(base, axis=1, keepdims=True)
        offs = rng.uniform(-0.1, 0.1, (64, 1)).astype(np.float32)
        return v, f, (base + offs * normal_dir).astype(np.float32), 64, 512
    v, f = _sphere_mesh(20, 0.6)  # "closest": test_closest_point_on_mesh
    q = (rng.rand(50, 3).astype(np.float32) * 2.0) - 1.0
    return v, f, q, 32, 256


CASES = ("sphere", "cube_corners", "grid_field", "closest")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the eager ops here are many and small, and the
    suite runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's ops (imported here, so that the ``cuda`` tests
    also run where jax is not installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops import meshdist, raycast

    return jnp, meshdist, raycast


def _face_dist64(v, f, p, face):
    a, b, c = (tr.planes(torch.as_tensor(v[f[face, k]], dtype=torch.float64))
               for k in range(3))
    sq, _ = tm._point_triangle_closest(
        tr.planes(torch.as_tensor(p, dtype=torch.float64)), a, b, c)
    return sq.sqrt().numpy()


def assert_face_ids_match(v, f, q, want, got):
    """Face ids equal, except at exact ties (both faces at the same
    float64 distance from the query)."""
    diff = np.nonzero(want != got)[0]
    np.testing.assert_allclose(_face_dist64(v, f, q[diff], want[diff]),
                               _face_dist64(v, f, q[diff], got[diff]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_signed_distance_matches_jax(case, jx):
    jnp, jm, jr = jx
    v, f, q, qb, chunk = _case(case)
    want = jm.signed_distance(v, f, q, query_batch=qb, tri_chunk=chunk)
    got = tm.signed_distance(v, f, q, query_batch=qb, tri_chunk=chunk,
                             device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.sign(got) == np.sign(want)).all()

    ja = jr.pad_triangles(v, f, chunk)
    ta = tr.pad_triangles(v, f, chunk, device="cpu")
    d_j, w_j = jm.signed_distance_padded(jnp.asarray(q), *ja, tri_chunk=chunk)
    d_t, w_t = tm.signed_distance_padded(torch.as_tensor(q), *ta,
                                         tri_chunk=chunk)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_closest_point_matches_jax(case, jx):
    _, jm, _ = jx
    v, f, q, qb, chunk = _case(case)
    cp_j, d_j, id_j = jm.closest_point_on_mesh(v, f, q, query_batch=qb,
                                               tri_chunk=chunk)
    cp_t, d_t, id_t = tm.closest_point_on_mesh(v, f, q, query_batch=qb,
                                               tri_chunk=chunk, device="cpu")
    assert cp_t.dtype == np.float32 and id_t.dtype == np.int64
    np.testing.assert_allclose(cp_t, cp_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
    assert_face_ids_match(v, f, q, id_j, id_t)


def test_signed_distance_abc_ground_truth():
    """The reference's own trimesh distances for abc_minimal's 2,000 query
    points (clipped to [-1, 1] as make_dataset clips them)."""
    v, f = mesh_io.load_mesh(os.path.join(ABC, "03_meshes", ABC_SMALL))
    q = np.load(os.path.join(ABC, "05_query_pts", ABC_SMALL + ".npy"))
    gt = np.load(os.path.join(ABC, "05_query_dist", ABC_SMALL + ".npy"))
    assert len(f) == 2872 and len(q) == 2000
    got = np.clip(tm.signed_distance(v, f, q, device="cpu"), -1.0, 1.0)
    np.testing.assert_allclose(got, gt, rtol=0, atol=1e-4)
    assert (np.sign(got) == np.sign(gt)).all()


def _rays(n=2000, seed=1):
    rng = np.random.RandomState(seed)
    o = np.tile(np.array([[0.1, -3.0, 0.05]], np.float32), (n, 1))
    d = (rng.randn(n, 3) * 0.2).astype(np.float32)
    d[:, 1] = 1.0
    return o, d


def test_raycast_matches_jax(jx):
    """Rays from outside a marched sphere: the same hits, t to 1e-5."""
    jnp, _, jr = jx
    v, f = _sphere_mesh(28, 0.5)
    o, d = _rays()
    ja = jr.pad_triangles(v, f, 512)
    t_j, id_j = jr.raycast_padded(jnp.asarray(o), jnp.asarray(d), *ja,
                                  tri_chunk=512)
    t_j, id_j = np.asarray(t_j), np.asarray(id_j)
    ta = tr.pad_triangles(v, f, 512, device="cpu")
    t_t, id_t = tr.raycast_padded(torch.as_tensor(o), torch.as_tensor(d),
                                  *ta, tri_chunk=512)
    assert t_t.dtype == torch.float32 and id_t.dtype == torch.int32
    t_t, id_t = t_t.numpy(), id_t.numpy()
    hit_j, hit_t = np.isfinite(t_j), np.isfinite(t_t)
    assert 400 < hit_j.sum() < len(o)
    assert (hit_j == hit_t).mean() >= 0.999
    both = hit_j & hit_t & (id_j == id_t)
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=0, atol=1e-5)
    assert (id_t[~hit_t] == -1).all()
    assert (id_j == id_t).mean() >= 0.999


def test_raycast_first_index_wins():
    """The same triangle three times: at index 1, 2 (same chunk) and 5 (the
    next chunk). Every hit reports index 1."""
    tri = np.array([[-1.0, 1.0, -1.0], [3.0, 1.0, -1.0], [-1.0, 1.0, 3.0]],
                   np.float32)
    far = tri + np.array([0.0, 2.0, 0.0], np.float32)
    v = np.concatenate([far, tri], 0)
    f = np.array([[0, 1, 2], [3, 4, 5], [3, 4, 5], [0, 1, 2], [0, 1, 2],
                  [3, 4, 5]], np.int64)
    o = np.zeros((3, 3), np.float32)
    d = np.array([[0.1, 1.0, 0.2], [0.0, -1.0, 0.0], [0.3, 1.0, 0.1]],
                 np.float32)
    t, ids = tr.raycast_padded(torch.as_tensor(o), torch.as_tensor(d),
                               *tr.pad_triangles(v, f, 4, device="cpu"),
                               tri_chunk=4)
    np.testing.assert_array_equal(ids.numpy(), [1, -1, 1])
    np.testing.assert_allclose(t.numpy()[[0, 2]], 1.0)
    assert np.isinf(t.numpy()[1])


def test_row_blocks_do_not_change_results(monkeypatch):
    """Splitting a call's rows into blocks (bounded working set) gives the
    same bits as one block."""
    v, f, q, _, chunk = _case("sphere")
    o, d = _rays(300)
    ta = tr.pad_triangles(v, f, chunk, device="cpu")
    qt, ot, dt = (torch.as_tensor(x) for x in (q, o, d))

    def run():
        return (tm.signed_distance_padded(qt, *ta, tri_chunk=chunk)
                + tm.closest_point_padded(qt, *ta, tri_chunk=chunk)
                + tr.raycast_padded(ot, dt, *ta, tri_chunk=chunk))

    whole = run()
    monkeypatch.setattr(tr, "PAIRS_PER_BLOCK", chunk * 37)
    assert len(tr.row_blocks(len(q), chunk)) == 14
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU the entry points raise instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f, q, _, _ = _case("cube_corners")
    for fn in (tm.signed_distance, tm.closest_point_on_mesh):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(v, f, q)
    with pytest.raises(RuntimeError, match="is_available"):
        tr.pad_triangles(v, f)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_meshdist_cuda_matches_cpu(cuda_device, case):
    v, f, q, qb, chunk = _case(case)
    want = tm.signed_distance(v, f, q, qb, chunk, device="cpu")
    got = tm.signed_distance(v, f, q, qb, chunk, device=cuda_device)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.sign(got) == np.sign(want)).all()
    cp_c, d_c, id_c = tm.closest_point_on_mesh(v, f, q, qb, chunk,
                                               device="cpu")
    cp_g, d_g, id_g = tm.closest_point_on_mesh(v, f, q, qb, chunk,
                                               device=cuda_device)
    np.testing.assert_allclose(cp_g, cp_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_g, d_c, rtol=0, atol=1e-5)
    assert_face_ids_match(v, f, q, id_c, id_g)


@pytest.mark.cuda
def test_raycast_cuda_matches_cpu(cuda_device):
    v, f = _sphere_mesh(28, 0.5)
    o, d = _rays()
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        t, ids = tr.raycast_padded(
            torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            *tr.pad_triangles(v, f, 512, device=dev), tri_chunk=512)
        out[dev.type] = (t.cpu().numpy(), ids.cpu().numpy())
    (t_c, id_c), (t_g, id_g) = out["cpu"], out["cuda"]
    assert (np.isfinite(t_c) == np.isfinite(t_g)).mean() >= 0.999
    both = np.isfinite(t_c) & np.isfinite(t_g) & (id_c == id_g)
    np.testing.assert_allclose(t_g[both], t_c[both], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_signed_distance_abc_ground_truth_cuda(cuda_device):
    for name in sorted(os.listdir(os.path.join(ABC, "03_meshes"))):
        v, f = mesh_io.load_mesh(os.path.join(ABC, "03_meshes", name))
        q = np.load(os.path.join(ABC, "05_query_pts", name + ".npy"))
        gt = np.load(os.path.join(ABC, "05_query_dist", name + ".npy"))
        got = np.clip(tm.signed_distance(v, f, q, device=cuda_device),
                      -1.0, 1.0)
        np.testing.assert_allclose(got, gt, rtol=0, atol=1e-4)
        assert (np.sign(got) == np.sign(gt)).all()
