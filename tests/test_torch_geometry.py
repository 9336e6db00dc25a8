"""Port parity: points2surf_tpu_torch.ops.geometry against the JAX package."""

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import geometry as tg

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from points2surf_tpu.ops import geometry as jg  # noqa: E402

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quat_to_rotmat_matches_jax(rng):
    q = rng.randn(7, 5, 4).astype(np.float32)
    np.testing.assert_allclose(tg.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jg.quat_to_rotmat(jnp.asarray(q))),
                               atol=ATOL)


def test_transform_points_matches_jax(rng):
    pts = rng.randn(6, 40, 3).astype(np.float32)
    rot = np.asarray(jg.quat_to_rotmat(jnp.asarray(
        rng.randn(6, 4).astype(np.float32))))
    np.testing.assert_allclose(
        tg.transform_points(_t(pts), _t(rot)).numpy(),
        np.asarray(jg.transform_points(jnp.asarray(pts), jnp.asarray(rot))),
        atol=ATOL)


def test_patch_radii_and_patch_space_match_jax(rng):
    pts = (rng.rand(9, 50, 3) * 1.6 - 0.8).astype(np.float32)
    q = (rng.rand(9, 3) * 1.6 - 0.8).astype(np.float32)
    r_t = tg.patch_radii(_t(pts), _t(q))
    r_j = jg.patch_radii(jnp.asarray(pts), jnp.asarray(q))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=ATOL)
    ps_t = tg.model_space_to_patch_space(_t(pts), _t(q), r_t)
    ps_j = jg.model_space_to_patch_space(jnp.asarray(pts), jnp.asarray(q),
                                         r_j)
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), atol=ATOL)
    np.testing.assert_allclose(
        tg.patch_space_to_model_space(ps_t, _t(q), r_t).numpy(), pts,
        atol=ATOL)


def test_random_quaternion_unit_and_uniform():
    gen = torch.Generator().manual_seed(0)
    q = tg.random_quaternion(gen, (20000,), device="cpu")
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(),
                               1.0, atol=1e-5)
    # uniform on S^3: every component has mean 0 and variance 1/4
    np.testing.assert_allclose(q.mean(0).numpy(), 0.0, atol=0.02)
    np.testing.assert_allclose((q * q).mean(0).numpy(), 0.25, atol=0.01)
    rot = tg.random_rotation(gen, (100,), device="cpu")
    eye = torch.matmul(rot, rot.transpose(1, 2))
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3),
                                                            eye.shape),
                               atol=1e-5)


def test_require_cuda():
    from points2surf_tpu_torch.device import require_cuda

    assert require_cuda("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            require_cuda("cuda")
