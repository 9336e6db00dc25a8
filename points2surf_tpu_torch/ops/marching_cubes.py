"""Host-side isosurface extraction: marching tetrahedra (counterpart of
``points2surf_tpu/ops/marching_cubes.py``).

Plays the role of skimage's ``marching_cubes_lewiner`` in the reference
(source/sdf.py:215). The Kuhn 6-tetrahedra cube decomposition keeps the case
table tiny and derivable, the output is watertight on watertight fields, and
shared cube-face diagonals agree between neighbors by construction.

``extract_isosurface`` runs the C++ build (``csrc/marching.cpp``, loaded by
``ops/marching_native.py``) and raises if it cannot be built or loaded.
``marching_tetrahedra`` here is its plain numpy version: the same
decomposition and case table, used by the tests as the reference.

Faces are oriented coherently BY CONSTRUCTION: all six Kuhn tets have
positive parity, so a case table whose windings point from the inside
region toward the outside region (see ``_orient_case_table``) yields a
globally consistent surface with normals toward the negative (outside)
side.
"""

from __future__ import annotations

import numpy as np

from points2surf_tpu_torch.ops import marching_native

# Kuhn decomposition around the main diagonal c0-c6.
# Cube corner local offsets (x, y, z):
_CORNERS = np.asarray(
    [
        (0, 0, 0),  # 0
        (1, 0, 0),  # 1
        (1, 1, 0),  # 2
        (0, 1, 0),  # 3
        (0, 0, 1),  # 4
        (1, 0, 1),  # 5
        (1, 1, 1),  # 6
        (0, 1, 1),  # 7
    ],
    np.int64,
)
_TETS = np.asarray(
    [
        (0, 1, 2, 6),
        (0, 2, 3, 6),
        (0, 3, 7, 6),
        (0, 7, 4, 6),
        (0, 4, 5, 6),
        (0, 5, 1, 6),
    ],
    np.int64,
)

# case table: bitmask of "corner value > level" -> list of triangles,
# each triangle a list of 3 edges, each edge (inside_corner, outside_corner)
_CASES: list[list[list[tuple[int, int]]]] = [[] for _ in range(16)]
_CASES[0b0001] = [[(0, 1), (0, 2), (0, 3)]]
_CASES[0b0010] = [[(1, 0), (1, 2), (1, 3)]]
_CASES[0b0100] = [[(2, 0), (2, 1), (2, 3)]]
_CASES[0b1000] = [[(3, 0), (3, 1), (3, 2)]]
_CASES[0b0011] = [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]]
_CASES[0b0101] = [[(0, 1), (0, 3), (2, 3)], [(0, 1), (2, 3), (2, 1)]]
_CASES[0b1001] = [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]]
_CASES[0b0110] = [[(1, 0), (1, 3), (2, 3)], [(1, 0), (2, 3), (2, 0)]]
_CASES[0b1010] = [[(1, 0), (1, 2), (3, 2)], [(1, 0), (3, 2), (3, 0)]]
_CASES[0b1100] = [[(2, 0), (2, 1), (3, 1)], [(2, 0), (3, 1), (3, 0)]]
_CASES[0b1110] = [[(1, 0), (2, 0), (3, 0)]]
_CASES[0b1101] = [[(0, 1), (2, 1), (3, 1)]]
_CASES[0b1011] = [[(0, 2), (1, 2), (3, 2)]]
_CASES[0b0111] = [[(0, 3), (1, 3), (2, 3)]]


def _orient_case_table():
    """Fix each case's triangle windings so normals point intrinsically
    from the inside (value > level) region toward the outside region.

    All six Kuhn tets share POSITIVE parity (det of their corner frames
    > 0 — that is what makes a single index-based case table geometrically
    consistent across them), so windings derived in one canonical
    positive-parity tet give a globally consistent, coherently oriented
    surface — no per-face gradient pass needed.
    """
    canon = np.asarray(_CORNERS[[0, 1, 2, 6]], np.float64)  # first Kuhn tet
    for mask in range(16):
        tris = _CASES[mask]
        if not tris:
            continue
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if not (mask >> i) & 1]
        d = canon[outside].mean(0) - canon[inside].mean(0)
        for tri in tris:
            pts = np.asarray(
                [(canon[a] + canon[b]) / 2.0 for a, b in tri]
            )
            n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
            dot = float(np.dot(n, d))
            assert abs(dot) > 1e-9, (mask, tri)
            if dot < 0:
                tri[1], tri[2] = tri[2], tri[1]


_orient_case_table()


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0):
    """Extract the `level` isosurface of a dense 3-D scalar field.

    Args:
      vol: (X, Y, Z) float volume.
      level: iso level.

    Returns:
      vertices: (V, 3) float32, in voxel-index coordinates (like skimage).
      faces: (F, 3) int64, coherently oriented (normals toward the
        negative side of the field).
    """
    vol = np.ascontiguousarray(vol, np.float32)
    rx, ry, rz = vol.shape

    tri_counts = 0
    all_edges = []

    # global corner id of voxel vertex (x, y, z)
    def gid(x, y, z):
        return (x * ry + y) * rz + z

    # precompute per-slab cube corner index grids
    cx, cy = np.meshgrid(
        np.arange(rx - 1, dtype=np.int64),
        np.arange(ry - 1, dtype=np.int64),
        indexing="ij",
    )
    cx = cx.ravel()
    cy = cy.ravel()

    for z in range(rz - 1):
        # (Ncubes, 8) corner values and gids
        vals8 = np.empty((cx.size, 8), np.float32)
        gids8 = np.empty((cx.size, 8), np.int64)
        for ci, (ox, oy, oz) in enumerate(_CORNERS):
            vals8[:, ci] = vol[cx + ox, cy + oy, z + oz]
            gids8[:, ci] = gid(cx + ox, cy + oy, z + oz)

        # skip cubes with no crossing
        inside8 = vals8 > level
        active = (inside8.any(axis=1)) & (~inside8.all(axis=1))
        if not active.any():
            continue
        gids8 = gids8[active]
        inside8 = inside8[active]

        # (Ntet, 4)
        gids4 = gids8[:, _TETS].reshape(-1, 4)
        in4 = inside8[:, _TETS].reshape(-1, 4)
        case = (
            in4[:, 0].astype(np.int8)
            + (in4[:, 1] << 1)
            + (in4[:, 2] << 2)
            + (in4[:, 3] << 3)
        )

        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in _CASES[c]:
                # tri: 3 edges -> (Nsel, 3, 2) gids
                e = np.empty((sel.size, 3, 2), np.int64)
                for k, (i, j) in enumerate(tri):
                    e[:, k, 0] = gids4[sel, i]
                    e[:, k, 1] = gids4[sel, j]
                all_edges.append(e)
                tri_counts += sel.size

    if tri_counts == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    edges = np.concatenate(all_edges, axis=0)  # (F, 3, 2)
    flat = edges.reshape(-1, 2)
    # canonical undirected key for dedup
    key = np.where(
        flat[:, 0] < flat[:, 1],
        flat[:, 0] * (rx * ry * rz) + flat[:, 1],
        flat[:, 1] * (rx * ry * rz) + flat[:, 0],
    )
    uniq_key, inverse = np.unique(key, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    # representative (inside, outside) pair per unique edge
    first = np.zeros(uniq_key.size, np.int64)
    first[inverse[::-1]] = np.arange(flat.shape[0] - 1, -1, -1)
    rep = flat[first]  # (V, 2) gids, ordered (inside, outside)

    vi, vo = rep[:, 0], rep[:, 1]
    flat_vol = vol.ravel()
    fi, fo = flat_vol[vi], flat_vol[vo]
    t = (level - fi) / (fo - fi)
    pos_i = np.stack(
        [vi // (ry * rz), (vi // rz) % ry, vi % rz], axis=1
    ).astype(np.float32)
    pos_o = np.stack(
        [vo // (ry * rz), (vo // rz) % ry, vo % rz], axis=1
    ).astype(np.float32)
    vertices = pos_i + t[:, None].astype(np.float32) * (pos_o - pos_i)

    # drop degenerate faces (two edges collapsed to the same vertex)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return vertices, faces[good]


def extract_isosurface(vol: np.ndarray, level: float = 0.0):
    """Isosurface extraction by the C++ build of marching tetrahedra.

    Vertices and faces come out in one fixed order, whatever the number of
    OpenMP threads. Raises if the native library cannot be built or loaded:
    there is no silent fallback to the ~8x slower numpy version."""
    return marching_native.marching_tetrahedra(vol, level)
