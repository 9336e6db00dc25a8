"""Port parity: the procedural mesh zoo (``datagen/procedural.py``) against
the JAX package on the CPU.

Every draw is numpy's, seeded the same way in both packages. ``icosphere``,
the ``bumpy`` and ``hull`` meshes (no marching) are equal bit for bit. The
``csg`` and ``thin`` styles march their SDF grid, the port through its own
C++ build (``csrc/marching.cpp``), the JAX package through ``native/``: the
two marchers emit the same triangles in a different order, and
``Mesh.cleaned`` sorts the vertices, so those meshes are equal as arrays of
vertices and as sets of oriented faces. ``make_procedural_meshes`` writes
the same layout and, for the unmarched styles, the same bytes.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from points2surf_tpu.datagen import procedural as jp  # noqa: E402
from points2surf_tpu_torch.datagen import procedural as tp
from points2surf_tpu_torch.utils import mesh_io
from points2surf_tpu_torch.utils.mesh import Mesh


def _oriented_face_set(faces):
    """Each face rotated to start at its least index (orientation kept),
    rows sorted."""
    f = np.asarray(faces)
    r = np.argmin(f, axis=1)
    rolled = np.stack([f[np.arange(len(f)), (r + k) % 3] for k in range(3)],
                      axis=1)
    return rolled[np.lexsort(rolled.T[::-1])]


def assert_same_mesh(got, want, exact):
    assert got.vertices.dtype == want.vertices.dtype == np.float32
    assert got.vertices.tobytes() == want.vertices.tobytes()
    if exact:
        assert got.faces.tobytes() == want.faces.tobytes()
    else:
        np.testing.assert_array_equal(_oriented_face_set(got.faces),
                                      _oriented_face_set(want.faces))


def test_icosphere_matches_jax():
    for sub in range(4):
        (v_j, f_j), (v_t, f_t) = jp.icosphere(sub), tp.icosphere(sub)
        assert v_t.tobytes() == v_j.tobytes()
        assert f_t.tobytes() == f_j.tobytes()


@pytest.mark.parametrize("style", ["bumpy", "hull"])
def test_unmarched_styles_bit_for_bit(style):
    for seed in range(3):
        got, want = tp.generate_mesh(seed, style), jp.generate_mesh(seed, style)
        assert_same_mesh(got, want, exact=True)
        assert got.is_watertight() and got.volume > 1e-6


@pytest.mark.parametrize("style,seeds", [("csg", (0, 1, 2)),
                                         ("thin", (400,))])
def test_marched_styles_as_sets(style, seeds):
    for seed in seeds:
        got, want = tp.generate_mesh(seed, style), jp.generate_mesh(seed, style)
        assert_same_mesh(got, want, exact=False)
        assert got.is_watertight()
        assert got.volume == pytest.approx(want.volume, rel=1e-5)


def test_default_style_mix_matches_jax():
    """style=None draws the style from the seed's stream: both packages
    draw the same one."""
    for seed in range(4):
        got, want = tp.generate_mesh(seed), jp.generate_mesh(seed)
        assert_same_mesh(got, want, exact=False)


def test_make_procedural_meshes_layout(tmp_path):
    out = {}
    for pkg, mod in (("jax", jp), ("torch", tp)):
        d = tmp_path / pkg
        names = mod.make_procedural_meshes(str(d), 5, seed=100,
                                           styles=["bumpy", "hull", "csg"])
        out[pkg] = (names, d / "00_base_meshes")
    (n_j, d_j), (n_t, d_t) = out["jax"], out["torch"]
    assert n_t == n_j == [f"proc_{i:05d}" for i in range(100, 105)]
    assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j))
    for i, name in enumerate(n_t):
        p_j, p_t = d_j / (name + ".ply"), d_t / (name + ".ply")
        got, want = (Mesh(*mesh_io.load_mesh(str(p))) for p in (p_t, p_j))
        assert got.is_watertight()
        if i % 3 != 2:  # bumpy, hull
            assert p_t.read_bytes() == p_j.read_bytes()
        else:
            assert_same_mesh(got, want, exact=False)
    # an existing file is kept (large runs resume)
    m = os.path.getmtime(d_t / "proc_00100.ply")
    tp.make_procedural_meshes(str(tmp_path / "torch"), 1, seed=100)
    assert os.path.getmtime(d_t / "proc_00100.ply") == m
