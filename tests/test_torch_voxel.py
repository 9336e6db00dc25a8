"""Port parity: the reconstruction query set (``ops/voxel.py``)."""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import voxel as tv
from points2surf_tpu_torch.utils import trace

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from points2surf_tpu.ops import voxel as jv  # noqa: E402

CLOUD = os.path.join(os.path.dirname(__file__), "..", "datasets",
                     "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")


def test_grid_query_points_bit_identical():
    pts = np.load(CLOUD)[:, :3].astype(np.float32)
    got = tv.grid_query_points(pts, 64, 3, device="cpu")
    want = jv.grid_query_points(pts, 64, 3)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5])
def test_box_sum_int_matches_jax(rng, size):
    vol = rng.randint(-1, 2, (12, 9, 7)).astype(np.float32)
    got = tv._box_sum_int(torch.from_numpy(vol), size).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jv._box_sum_int(jnp.asarray(vol), size)))


@pytest.mark.parametrize("res", [1, 3, 16, 33])
def test_grid_helpers_match_jax(res):
    got = tv.make_grid_points(res)
    want = jv.make_grid_points(res)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ids = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    back = tv.volume_space_to_model_space(torch.from_numpy(ids), res)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jv.volume_space_to_model_space(
            jnp.asarray(ids), res)))
    # each voxel centre maps back to its voxel
    np.testing.assert_array_equal(tv.model_space_to_volume_space(
        torch.from_numpy(got), res).numpy(), ids)


def test_voxelize_ignores_padding(rng):
    pts = (rng.rand(300, 3) * 2 - 1).astype(np.float32)
    got = tv.voxelize(torch.from_numpy(pts), 200, 16).numpy()
    want = np.asarray(jv.voxelize(jnp.asarray(pts), 200, 16))
    np.testing.assert_array_equal(got, want)


def test_splat_to_volume_with_padding_rows(rng):
    res = 16
    q = tv.make_grid_points(res)[::7]
    n_valid = len(q)
    # padding rows: a repeat of the first query (the sweep's padding) and
    # zeros, each carrying a value that must not reach the volume
    pts = np.concatenate([q, np.repeat(q[:1], 5, 0),
                          np.zeros((6, 3), np.float32)]).astype(np.float32)
    vals = rng.randn(len(pts)).astype(np.float32)
    got = tv.splat_to_volume(torch.from_numpy(pts), torch.from_numpy(vals),
                             n_valid, res).numpy()
    want = np.asarray(jv.splat_to_volume(jnp.asarray(pts), jnp.asarray(vals),
                                         n_valid, res))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) == n_valid


def _sparse_seeds(rng, res, density=0.08, flip=0.02):
    """Sparse sphere seeds (inside +, outside -) with a few wrong signs."""
    centers = tv.make_grid_points(res).reshape(res, res, res, 3)
    d = np.linalg.norm(centers, axis=-1)
    vol = np.zeros((res, res, res), np.float32)
    seeds = rng.rand(res, res, res) < density
    vol[seeds] = np.where(d[seeds] < 0.5, 0.4, -0.4)
    wrong = seeds & (rng.rand(res, res, res) < flip)
    vol[wrong] *= -1.0
    return vol


@pytest.mark.parametrize("threshold", [2, 4])
def test_filter_seed_signs_matches_jax(rng, threshold):
    vol = _sparse_seeds(rng, 20, density=0.3, flip=0.1)
    got = tv.filter_seed_signs(torch.from_numpy(vol), 3, threshold).numpy()
    want = np.asarray(jv.filter_seed_signs(jnp.asarray(vol), 3, threshold))
    np.testing.assert_array_equal(got, want)
    assert (got != vol).any()  # the filter did drop seeds


@pytest.mark.parametrize("sigma,certainty,res", [(3, 3, 20), (5, 13, 20),
                                                 (5, 13, 17)])
def test_propagate_sign_matches_jax(rng, sigma, certainty, res):
    vol = _sparse_seeds(rng, res)
    with trace.recording() as recording:
        got = tv.propagate_sign(torch.from_numpy(vol), sigma,
                                certainty).numpy()
    want = np.asarray(jv.propagate_sign(jnp.asarray(vol), sigma, certainty))
    np.testing.assert_array_equal(got, want)
    assert recording["counters"]["volume.rounds"] >= 2
    assert (got[1:-1, 1:-1, 1:-1] != 0).mean() > 0.9


def test_box_sum_int_size_17_exact(rng):
    """The fp32 band matmuls are exact at any size < 256 on integer volumes
    (partial sums <= size^3), where JAX's size^2 > 256 fallback is not."""
    from scipy import ndimage

    vol = rng.choice([-1.0, 0.0, 1.0], size=(40, 33, 21)).astype(np.float32)
    got = tv._box_sum_int(torch.from_numpy(vol), 17).numpy()
    want = ndimage.convolve(vol, np.ones((17,) * 3, np.float32),
                            mode="nearest")
    np.testing.assert_array_equal(got, want)
