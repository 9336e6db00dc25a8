"""The plain reference against the port on the CPU at a small size: a
reconstruction window's query batches, grid and volume, and a training
window's three checked steps, each through the cell's own check."""

import numpy as np
import pytest
import torch

import harness
import run
from conftest import tiny
from reference import volume as ref_volume

CELLS = ["p2s_vanilla.recon", "p2s_vanilla.train", "p2s_max.train",
         "p2s_max.recon"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    torch.set_num_threads(2)
    _, cfg = harness.cell(cell)
    line = run.drive(cell, seed=2 ** 31 + 11, seconds=1.0, trace=False,
                     device="cpu", cfg=tiny(cfg))
    assert line["correct"], line["checks"]
    for name, c in line["checks"].items():
        assert c["value"] <= (0 if name.endswith("_diff") else 1e-2), name


def test_grid_and_volume_match_the_port():
    from points2surf_tpu_torch.ops import voxel

    pts = np.load(harness.ROOT / "datasets/abc_minimal/04_pts/"
                  "00994122_57d9d4755722f9d2d7436f0a_trimesh_000.xyz.npy")
    got = voxel.grid_query_points(pts, 32, 3, device="cpu")
    want = ref_volume.grid_queries(torch.as_tensor(pts), 32, 3)
    assert torch.equal(torch.as_tensor(got), want)
    dist = torch.as_tensor(got[:, 0] - np.median(got[:, 0]))
    vol = voxel.propagate_sign(
        voxel.splat_to_volume(want, dist, len(want), 32), 5, 13)
    assert torch.equal(torch.clamp(vol, -1, 1),
                       ref_volume.volume(want, dist, 32, 5, 13))


def test_box_sum_replicates_edges():
    x = torch.zeros((4, 4, 4), dtype=torch.int64)
    x[0, 0, 0] = 1
    s = ref_volume.box_sum(x, 3)
    # the corner voxel is counted once per edge-replicated neighbour slot
    assert int(s[0, 0, 0]) == 8 and int(s[1, 1, 1]) == 1
    assert int(s[2, 2, 2]) == 0
