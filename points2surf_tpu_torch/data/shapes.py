"""Shape store: dataset directory layout, host metadata, device-resident cache
(counterpart of ``points2surf_tpu/data/shapes.py``).

Replaces the reference's PointcloudPatchDataset shape handling
(source/data_loader.py:16-68, 177-318). Point clouds are kept on the
store's device across batches, zero-padded to 16,384-row buckets, so a
cloud's padded size (and with it the sub-sample's candidate count) is the
JAX package's; the kd-tree role is played by the brute-force selection of
``ops/patches.py``.

Dataset layout (identical to the reference, SURVEY §2.2):
  <root>/04_pts/<name>.xyz.npy          float32 (N, >=3) point cloud
  <root>/05_query_pts/<name>.ply.npy    float32 (Q, 3) GT query points
  <root>/05_query_dist/<name>.ply.npy   float32 (Q,) GT signed distances
  <root>/<set>.txt                      one shape stem per line

Reconstruction grids are cached on disk under
``<root>/cache/grid_queries_r{res}_e{eps}/<name>.npy``, the JAX package's
path and contents, so either package reads the other's cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.ops import voxel
from points2surf_tpu_torch.utils import file_utils, trace

BUCKET = 16384  # point-count padding granularity


def bucket_size(n: int) -> int:
    return max(BUCKET, -(-n // BUCKET) * BUCKET)


@dataclasses.dataclass
class Shape:
    """Host-side view of one shape."""

    name: str
    pts: np.ndarray  # (N, 3) float32
    query_pts: Optional[np.ndarray]  # (Q, 3) float32 or None
    query_dist: Optional[np.ndarray]  # (Q,) float32 or None

    @property
    def n_points(self) -> int:
        return self.pts.shape[0]


class ShapeStore:
    """Loads shapes of one dataset split and caches them on ``device``.

    Args:
      root: dataset directory.
      shape_list_filename: e.g. 'trainset.txt' (reference data_loader.py:263-267).
      with_query: load GT query points/distances (training & eval mode).
      reconstruction: query points are grid voxel centers near the cloud
        (reference data_loader.py:300-310), computed on ``device``.
      query_grid_resolution / epsilon: reconstruction grid parameters.
      cache_capacity: LRU capacity of the host shapes and of the
        device-resident point clouds (reference Cache, data_loader.py:186-211).
      device: where the padded clouds live ("cuda" unless the caller asks
        for the CPU).
    """

    def __init__(
        self,
        root: str,
        shape_list_filename: str,
        *,
        with_query: bool = True,
        reconstruction: bool = False,
        query_grid_resolution: Optional[int] = None,
        epsilon: Optional[int] = None,
        cache_capacity: int = 16,
        device: torch.device | str = "cuda",
    ):
        self.root = root
        self.reconstruction = reconstruction
        self.query_grid_resolution = query_grid_resolution
        self.epsilon = epsilon
        self.cache_capacity = max(1, cache_capacity)
        self.device = require_cuda(device)

        list_path = os.path.join(root, shape_list_filename)
        with open(list_path) as f:
            self.shape_names = [ln.strip() for ln in f if ln.strip()]

        self.with_query = with_query
        self._host_cache: dict[int, Shape] = {}
        self._device_cache: dict[int, tuple[torch.Tensor, int]] = {}
        self._use_counter = 0
        self._used_at: dict[int, int] = {}

        # per-shape patch counts (reference data_loader.py:279-318).
        # Reconstruction counts need the grid queries of each shape, so they
        # are filled lazily on first get() (-1 = unknown).
        self.shape_patch_count: list[int] = []
        for name in self.shape_names:
            if with_query and not reconstruction:
                dist = np.load(
                    os.path.join(root, "05_query_dist", name + ".ply.npy"),
                    mmap_mode="r",
                )
                self.shape_patch_count.append(int(dist.shape[0]))
            elif reconstruction:
                self.shape_patch_count.append(-1)
            else:
                npy = os.path.join(root, "04_pts", name + ".xyz.npy")
                if os.path.isfile(npy):
                    pts = np.load(npy, mmap_mode="r")
                else:
                    pts = self._load_pts(name)
                self.shape_patch_count.append(int(pts.shape[0]))

    def _load_pts(self, name: str) -> np.ndarray:
        path = os.path.join(self.root, "04_pts", name + ".xyz")
        pts = file_utils.load_npy_if_valid(path, "float32")
        if pts.shape[1] > 3:
            pts = pts[:, :3]  # tolerate appended normals (data_loader.py:33-34)
        return np.ascontiguousarray(pts, np.float32)

    def _grid_queries(self, name: str, pts: np.ndarray) -> np.ndarray:
        """Reconstruction query points = grid voxel centers near the cloud,
        cached on disk keyed by (resolution, epsilon) and invalidated via
        mtime against the point cloud (reference-style call_necessary)."""
        pts_file = os.path.join(self.root, "04_pts", name + ".xyz.npy")
        cache_file = os.path.join(
            self.root,
            "cache",
            f"grid_queries_r{self.query_grid_resolution}_e{self.epsilon}",
            name + ".npy",
        )
        if os.path.isfile(pts_file) and not file_utils.call_necessary(
            pts_file, cache_file
        ):
            return np.load(cache_file).astype(np.float32)
        q = voxel.grid_query_points(pts, self.query_grid_resolution,
                                    self.epsilon, device=self.device)
        try:
            file_utils.make_dir_for_file(cache_file)
            np.save(cache_file, q)
        except OSError:
            pass  # read-only dataset dirs: just skip the disk cache
        return q

    def get(self, index: int) -> Shape:
        """Host-side shape (LRU-cached)."""
        self._use_counter += 1
        self._used_at[index] = self._use_counter
        if index in self._host_cache:
            return self._host_cache[index]
        name = self.shape_names[index]
        pts = self._load_pts(name)
        query_pts = None
        query_dist = None
        if self.reconstruction:
            query_pts = self._grid_queries(name, pts)
            self.shape_patch_count[index] = int(query_pts.shape[0])
        elif self.with_query:
            query_pts = np.load(
                os.path.join(self.root, "05_query_pts", name + ".ply.npy")
            ).astype(np.float32)
            query_dist = np.load(
                os.path.join(self.root, "05_query_dist", name + ".ply.npy")
            ).astype(np.float32)
        shape = Shape(name, pts, query_pts, query_dist)
        self._evict(self._host_cache)
        self._host_cache[index] = shape
        return shape

    def device_points(self, index: int) -> tuple[torch.Tensor, int]:
        """Bucket-padded (N_pad, 3) float32 tensor of the shape's points on
        the store's device, and the valid row count."""
        self._use_counter += 1
        self._used_at[index] = self._use_counter
        if index in self._device_cache:
            return self._device_cache[index]
        with trace.span("data.cloud_upload"):
            shape = self.get(index)
            n = shape.n_points
            padded = np.zeros((bucket_size(n), 3), np.float32)
            padded[:n] = shape.pts
            with trace.blocking(self.device):
                arr = torch.from_numpy(padded).to(self.device)
        self._evict(self._device_cache)
        self._device_cache[index] = (arr, n)
        return arr, n

    def _evict(self, cache: dict) -> None:
        while len(cache) >= self.cache_capacity:
            victim = min(
                cache.keys(), key=lambda k: self._used_at.get(k, -1)
            )
            del cache[victim]

    @property
    def total_patch_count(self) -> int:
        """Sum of per-shape patch counts. In reconstruction mode this forces
        the (disk-cached) grid-query computation for every not-yet-visited
        shape — prefer iterating shapes and reading counts as they fill."""
        for i, c in enumerate(self.shape_patch_count):
            if c < 0:
                self.get(i)
        return sum(self.shape_patch_count)
