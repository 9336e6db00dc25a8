"""Mesh processing for dataset generation and metrics (a copy of
``points2surf_tpu/utils/mesh.py``).

Plays the roles trimesh fills for the reference (watertightness checks,
cleanup, normalization, normals) on numpy: these are host-side offline
stages; the signed-distance math runs on the device in ``ops/meshdist.py``.
``cleaned()`` sorts the vertices (``np.unique``), so a cleaned mesh's vertex
order does not depend on the marcher that made it; its face order does.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int64

    # ---------------------------------------------------------- basics ----

    @property
    def face_normals(self) -> np.ndarray:
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        n = np.cross(v1 - v0, v2 - v0)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return n / np.maximum(norm, 1e-20)

    @property
    def face_areas(self) -> np.ndarray:
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)

    @property
    def volume(self) -> float:
        """Signed volume (positive for outward-oriented closed meshes)."""
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return float(np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() / 6.0)

    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    # ------------------------------------------------------- topology ----

    def _directed_edges(self) -> np.ndarray:
        f = self.faces
        return np.concatenate(
            [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
        )

    def is_watertight(self) -> bool:
        """Closed 2-manifold: every undirected edge appears exactly twice,
        once per direction (consistent orientation)."""
        if len(self.faces) == 0:
            return False
        de = self._directed_edges()
        und = np.sort(de, axis=1)
        _, counts = np.unique(und, axis=0, return_counts=True)
        if not (counts == 2).all():
            return False
        # orientation consistency: no directed edge may repeat
        _, dcounts = np.unique(de, axis=0, return_counts=True)
        return (dcounts == 1).all()

    # --------------------------------------------------------- repair ----

    def cleaned(self) -> "Mesh":
        """Merge duplicate vertices, drop degenerate/duplicate faces and
        unreferenced vertices (the role of the reference's trimesh-based
        cleanup, make_dataset.py:383-444)."""
        verts, inverse = np.unique(
            self.vertices.round(decimals=7), axis=0, return_inverse=True
        )
        faces = inverse[self.faces]
        nondegen = (
            (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2])
        )
        faces = faces[nondegen]
        # drop duplicate faces regardless of rotation
        key = np.sort(faces, axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        faces = faces[np.sort(first)]
        # compact unreferenced vertices
        used = np.unique(faces)
        remap = -np.ones(len(verts), np.int64)
        remap[used] = np.arange(len(used))
        return Mesh(
            verts[used].astype(np.float32), remap[faces].astype(np.int64)
        )

    def fixed_inversion(self) -> "Mesh":
        """Flip all faces if the signed volume is negative
        (trimesh.repair.fix_inversion equivalent, reference sdf.py:226)."""
        if self.volume < 0:
            return Mesh(self.vertices, self.faces[:, ::-1].copy())
        return self

    # ------------------------------------------------------ transforms ----

    def normalized_unit_cube(self, margin: float = 0.0) -> "Mesh":
        """Center at origin, scale the longest extent to (2 - 2*margin)
        so coordinates live in (-1, 1) (reference make_dataset.py:71-121)."""
        lo, hi = self.bounds()
        center = (lo + hi) / 2.0
        extent = float((hi - lo).max())
        scale = (2.0 - 2.0 * margin) / max(extent, 1e-12)
        return Mesh(
            ((self.vertices - center) * scale).astype(np.float32), self.faces
        )

    # -------------------------------------------------------- sampling ----

    def sample_surface(self, n: int, rng=None):
        """Area-weighted surface samples + face ids."""
        if rng is None:
            rng = np.random.RandomState(0)
        area = self.face_areas
        p = area / area.sum()
        fi = rng.choice(len(self.faces), size=n, p=p)
        u = rng.rand(n, 1)
        v = rng.rand(n, 1)
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        v0 = self.vertices[self.faces[fi, 0]]
        v1 = self.vertices[self.faces[fi, 1]]
        v2 = self.vertices[self.faces[fi, 2]]
        return (v0 + u * (v1 - v0) + v * (v2 - v0)).astype(np.float32), fi


def vertex_adjacency(mesh: "Mesh"):
    """Sparse vertex-adjacency matrix of a mesh
    (reference mesh_io.py:172-200 role)."""
    from scipy import sparse

    e = mesh._directed_edges()
    data = np.ones(len(e), np.int8)
    n = len(mesh.vertices)
    adj = sparse.coo_matrix((data, (e[:, 0], e[:, 1])), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.int8)
    return adj.tocsr()
