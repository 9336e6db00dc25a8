"""Port parity: the reconstruction query set (``ops/voxel.py``)."""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import voxel as tv

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


def test_voxelize_ignores_padding(rng):
    pts = (rng.rand(300, 3) * 2 - 1).astype(np.float32)
    got = tv.voxelize(torch.from_numpy(pts), 200, 16).numpy()
    want = np.asarray(jv.voxelize(jnp.asarray(pts), 200, 16))
    np.testing.assert_array_equal(got, want)
