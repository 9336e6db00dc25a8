"""Geometry primitives (counterpart of ``points2surf_tpu/ops/geometry.py``).

Channels-last layouts as in the JAX package: points are (..., n, 3),
rotations (..., 3, 3), quaternions (..., 4) as ``[w, x, y, z]``.
"""

from __future__ import annotations

import math

import torch

from points2surf_tpu_torch.device import require_cuda


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(Possibly unnormalized) quaternions (..., 4) -> rotations (..., 3, 3).

    Normalizes implicitly via ``s = 2 / |q|^2`` (reference
    source/base/utils.py:13-46)."""
    s = 2.0 / torch.sum(q * q, dim=-1)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - (y * y + z * z) * s, (x * y - z * w) * s, (x * z + y * w) * s],
        [(x * y + z * w) * s, 1.0 - (x * x + z * z) * s, (y * z - x * w) * s],
        [(x * z - y * w) * s, (y * z + x * w) * s, 1.0 - (x * x + y * y) * s],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def random_quaternion(generator: torch.Generator, shape=(),
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """Uniform random unit quaternions (Shoemake's method), [w, x, y, z],
    on ``device`` (the card unless the caller asks for the CPU)."""
    u = torch.rand(tuple(shape) + (3,), generator=generator,
                   device=require_cuda(device))
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    a = torch.sqrt(1.0 - u1)
    b = torch.sqrt(u1)
    t2 = 2.0 * math.pi * u2
    t3 = 2.0 * math.pi * u3
    return torch.stack(
        [a * torch.sin(t2), a * torch.cos(t2), b * torch.sin(t3),
         b * torch.cos(t3)],
        dim=-1,
    )


def random_rotation(generator: torch.Generator, shape=(),
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """Uniform random rotation matrices, shape (..., 3, 3), on ``device``
    (the card unless the caller asks for the CPU)."""
    return quat_to_rotmat(random_quaternion(generator, shape, device))


def transform_points(pts: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate points: (..., n, 3) by (..., 3, 3) -> (..., n, 3), in the
    promoted dtype of the two (a bf16 rotation turns fp32 points fp32, as in
    the JAX package)."""
    dtype = torch.promote_types(pts.dtype, rot.dtype)
    return torch.matmul(pts.to(dtype), rot.to(dtype).transpose(-1, -2))


def cartesian_dist(a: torch.Tensor, b: torch.Tensor,
                   axis: int = -1) -> torch.Tensor:
    """Euclidean distance along ``axis``."""
    return torch.linalg.vector_norm(a - b, dim=axis)


def patch_radii(pts_patch: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Adaptive kNN patch radius: max distance from the query (..., 3) to
    any patch point (..., n, 3) -> (...,)."""
    d = torch.linalg.vector_norm(pts_patch - query[..., None, :], dim=-1)
    return torch.amax(d, dim=-1)


def model_space_to_patch_space(pts_ms: torch.Tensor, center_ms: torch.Tensor,
                               radius_ms: torch.Tensor) -> torch.Tensor:
    """(pts - center) / radius for pts (..., n, 3), center (..., 3),
    radius (...,)."""
    return (pts_ms - center_ms[..., None, :]) / radius_ms[..., None, None]


def patch_space_to_model_space(pts_ps: torch.Tensor, center_ms: torch.Tensor,
                               radius_ms: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`model_space_to_patch_space`."""
    return pts_ps * radius_ms[..., None, None] + center_ms[..., None, :]
