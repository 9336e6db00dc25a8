"""Plain PyTorch reference of what the program derives from the inputs: the
reconstruction grid's near-surface queries, the patches and sub-samples of a
batch (from the benchmark's random draws), the post-processing and the
training losses.

Written from the upstream semantics (github.com/ErlerPhilipp/points2surf:
``source/sdf.py`` for the grid, ``source/data_loader.py`` and
``source/base/utils.py`` for the patches and the sub-sample,
``source/sdf_nn.py`` for the heads) as the port documents them: exact kNN
against the whole cloud, the patch radius the largest distance to a patch
point, the distance-weighted sub-sample as Efraimidis-Spirakis keys
``log(u) / w`` over a uniformly decimated candidate set (or uniform ids with
replacement), and the training rotation of patch, sub-sample and query.

The draws are made by the benchmark (:func:`make_draws`), handed to the
program as its ``SubsampleDraws`` / ``TrainDraws`` and to this reference as
the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.model import mm, quat_to_rotmat

BUCKET = 16384  # the cloud's padded size is a multiple of this
TINY = float(np.finfo(np.float32).tiny)


def padded(pts: np.ndarray, device) -> tuple[torch.Tensor, int]:
    """(N_pad, 3) zero-padded cloud on ``device`` and its valid row count."""
    n = pts.shape[0]
    n_pad = max(BUCKET, -(-n // BUCKET) * BUCKET)
    out = torch.zeros((n_pad, 3), dtype=torch.float32, device=device)
    out[:n] = torch.as_tensor(pts[:, :3], dtype=torch.float32, device=device)
    return out, n


def candidates(n: int, sub_n: int, depth: int) -> tuple[int, int]:
    """(stride, candidate count) of the sub-sample over a cloud padded to
    ``n`` rows: every ``stride``-th row from a random offset when the cloud
    holds more than twice ``max(2, depth) * sub_n`` rows, else every row
    (stride 0)."""
    target = max(2 * sub_n, depth * sub_n)
    if depth > 0 and n > 2 * target:
        stride = n // target
        return stride, n // stride
    return 0, n


def make_draws(generator: torch.Generator, b: int, n_pad: int, n_valid: int,
               patch: dict, depth: int, train: bool) -> dict:
    """The random numbers of one batch of ``b`` queries: the decimation
    offset and one log-uniform per candidate (or, for the uniform
    sub-sample, ids in [0, n_valid)), and with ``train`` one uniform
    rotation per row (Shoemake's quaternion)."""
    dev = generator.device
    sub_n = patch["sub_sample_size"]
    d = {"offset": None, "logu": None, "ids": None, "rot": None}
    if patch["uniform_subsample"]:
        d["ids"] = torch.randint(0, n_valid, (b, sub_n), generator=generator,
                                 device=dev)
    else:
        stride, n_cand = candidates(n_pad, sub_n, depth)
        d["offset"] = torch.randint(0, max(stride, 1), (),
                                    generator=generator, device=dev)
        u = torch.rand((b, n_cand), generator=generator, device=dev)
        d["logu"] = torch.log(u * (1.0 - TINY) + TINY)
    if train:
        u = torch.rand((b, 3), generator=generator, device=dev)
        a, c = torch.sqrt(1.0 - u[:, 0]), torch.sqrt(u[:, 0])
        t2, t3 = 2.0 * math.pi * u[:, 1], 2.0 * math.pi * u[:, 2]
        q = torch.stack([a * torch.sin(t2), a * torch.cos(t2),
                         c * torch.sin(t3), c * torch.cos(t3)], -1)
        d["rot"] = quat_to_rotmat(q)
    return d


def sqdist(q: torch.Tensor, p: torch.Tensor, tf32: bool) -> torch.Tensor:
    """|q|^2 - 2 q.p + |p|^2, clamped at 0: (B, 3) x (C, 3) -> (B, C)."""
    cross = mm(q, p.t(), tf32)
    return torch.clamp(torch.sum(q * q, 1)[:, None] - 2.0 * cross
                       + torch.sum(p * p, 1)[None, :], min=0.0)


# A row's selection is ambiguous to rounding where the k-th and (k+1)-th
# nearest squared distances lie within this share of the k-th (float32's
# |q|^2 - 2 q.p + |p|^2 is good to ~1e-7 of |q|^2 + |p|^2, ~1e-5 of a
# patch's squared radius), or the sub-sample's last kept and first dropped
# keys within this share of each other.
TIE = 1e-4


def patches(points: torch.Tensor, n_valid: int, queries: torch.Tensor,
            draws: dict, patch: dict, depth: int, train: bool,
            tf32: bool = False, rows: int = 256, ties: bool = False):
    """The network inputs of a batch: (patch points in patch space (B, k, 3),
    patch radius (B,), sub-sample in model space (B, S, 3), query in model
    space (B, 3)), ``rows`` queries at a time; with ``ties`` also (B,) bool,
    the rows whose selection is ambiguous to rounding (``TIE``)."""
    k, sub_n = patch["points_per_patch"], patch["sub_sample_size"]
    if patch["patch_radius"] > 0:
        raise ValueError("the reference covers kNN patches")
    n = points.shape[0]
    valid = torch.arange(n, device=points.device) < n_valid
    stride, n_cand = candidates(n, sub_n, depth)
    cols = torch.arange(n_cand, device=points.device)
    if stride and not patch["uniform_subsample"]:
        cols = draws["offset"] + stride * cols
    out = []
    for s in range(0, queries.shape[0], rows):
        q = queries[s:s + rows]
        d2 = torch.where(valid[None, :], sqdist(q, points, tf32),
                         float("inf"))
        v, ids = torch.topk(d2, min(k + 1, n), dim=1, largest=False)
        tie = (v[:, -1] - v[:, k - 1]) <= TIE * v[:, k - 1]
        v, ids = v[:, :k], ids[:, :k]
        pts = torch.where(torch.isfinite(v)[..., None], points[ids],
                          q[:, None, :])
        radius = torch.clamp(torch.amax(torch.linalg.vector_norm(
            pts - q[:, None, :], dim=2), dim=1), min=1e-12)
        pts_ps = (pts - q[:, None, :]) / radius[:, None, None]
        if patch["uniform_subsample"]:
            sub = points[draws["ids"][s:s + rows]]
        else:
            d = torch.sqrt(sqdist(q, points[cols], tf32))
            col_ok = cols < n_valid
            dmax = torch.amax(torch.where(col_ok[None, :], d,
                                          float("-inf")), 1, keepdim=True)
            w = torch.clamp(1.0 - 1.5 * d / dmax, 0.05, 1.0)
            key = torch.where(col_ok[None, :], draws["logu"][s:s + rows] / w,
                              float("-inf"))
            kv, at = torch.topk(key, min(sub_n + 1, key.shape[1]), dim=1)
            last, drop = kv[:, sub_n - 1], kv[:, -1]
            tie |= (last - drop).abs() <= TIE * last.abs()
            kv, at = kv[:, :sub_n], at[:, :sub_n]
            sub = torch.where(torch.isfinite(kv)[..., None],
                              points[cols[at]], 0.0)
        qm = q
        if train:
            rot = draws["rot"][s:s + rows]
            pts_ps = mm(pts_ps, rot.transpose(1, 2), tf32)
            sub = mm(sub, rot.transpose(1, 2), tf32)
            qm = mm(rot, q[:, :, None], tf32)[..., 0]
        out.append((pts_ps, radius, sub, qm) + ((tie,) if ties else ()))
    return tuple(torch.cat(t) for t in zip(*out))


def signed_distance(pred: torch.Tensor, radius: torch.Tensor):
    """(B, 2) raw magnitude and sign predictions -> (B,) model-space
    distances: tanh(p0)^2 * radius, negative where p1 < 0."""
    mag = torch.tanh(pred[:, 0]) ** 2 * radius
    return torch.where(pred[:, 1] >= 0.0, mag, -mag)


def losses(pred: torch.Tensor, gt: torch.Tensor, radius: torch.Tensor):
    """The two training losses of the magnitude and sign outputs: the mean
    squared difference of tanh(|p0|) and tanh(|gt| / radius), and the mean
    binary cross-entropy of p1 against (gt >= 0)."""
    target = torch.abs(gt) / radius
    mag = torch.mean((torch.tanh(torch.abs(pred[:, 0]))
                      - torch.tanh(target)) ** 2)
    z = (gt >= 0.0).to(pred.dtype)
    x = pred[:, 1]
    sign = torch.mean(torch.clamp(x, min=0.0) - x * z
                      + torch.log1p(torch.exp(-torch.abs(x))))
    return torch.stack([mag, sign])
