"""Port parity: the whole SDF query (extraction + forward + post-processing)
at a small width, on the bundled cloud, with bridged weights and the JAX
package's own random draws injected into the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.infer.query import (
    drain_batched_results,
    make_sdf_query_fn,
)
from points2surf_tpu_torch.models.p2s import PointsToSurfModel as TorchP2S
from points2surf_tpu_torch.models.weights import state_dict_from_flax
from points2surf_tpu_torch.ops import patches as tp

ROOT = os.path.join(os.path.dirname(__file__), "..")
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
KW = dict(points_per_patch=32, sub_sample_size=64, tile_candidates=1024,
          tile_queries=32, subsample_candidates=4)


def test_port_imports_no_jax():
    code = ("import sys, points2surf_tpu_torch.infer.query, "
            "points2surf_tpu_torch.models.weights, "
            "points2surf_tpu_torch.ops.voxel, "
            "points2surf_tpu_torch.train.trainer, "
            "points2surf_tpu_torch.ops.kernels.pooled_tail, "
            "points2surf_tpu_torch.infer.meshing, "
            "points2surf_tpu_torch.ops.marching_cubes, "
            "points2surf_tpu_torch.ops.marching_native, "
            "points2surf_tpu_torch.utils.mesh_io, "
            "points2surf_tpu_torch.utils.file_utils, "
            "points2surf_tpu_torch.utils.mp, "
            "points2surf_tpu_torch.data.samplers, "
            "points2surf_tpu_torch.data.shapes, "
            "points2surf_tpu_torch.data.pipeline, "
            "points2surf_tpu_torch.train.checkpoint, "
            "points2surf_tpu_torch.infer.evaluator, "
            "points2surf_tpu_torch.evalx.metrics, "
            "points2surf_tpu_torch.cli.train_args, "
            "points2surf_tpu_torch.cli.eval_args, "
            "points2surf_tpu_torch.cli.full_train, "
            "points2surf_tpu_torch.cli.full_eval, "
            "points2surf_tpu_torch.cli.full_run, "
            "points2surf_tpu_torch.utils.mesh, "
            "points2surf_tpu_torch.ops.raycast, "
            "points2surf_tpu_torch.ops.meshdist, "
            "points2surf_tpu_torch.datagen.scanner, "
            "points2surf_tpu_torch.datagen.procedural, "
            "points2surf_tpu_torch.datagen.make_dataset, "
            "points2surf_tpu_torch.datagen.make_pc_dataset, "
            "points2surf_tpu_torch.datagen.blensor, "
            "points2surf_tpu_torch.datagen.synthetic, "
            "points2surf_tpu_torch.datagen.deepsdf, "
            "points2surf_tpu_torch.cli.make_dataset, "
            "points2surf_tpu_torch.evalx.baselines, "
            "points2surf_tpu_torch.evalx.figures, "
            "points2surf_tpu_torch.parallel, "
            "points2surf_tpu_torch.parallel.distributed, "
            "points2surf_tpu_torch.parallel.mesh, "
            "points2surf_tpu_torch.cli.download, "
            "points2surf_tpu_torch.ops.knn; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'points2surf_tpu.')) or "
            "m == 'points2surf_tpu']; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sdf_query_matches_jax(monkeypatch):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from test_torch_patches import jax_draws

    from points2surf_tpu.infer.query import make_sdf_query_fn as jax_query_fn
    from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S
    from points2surf_tpu.ops.patches import PatchConfig as JaxCfg
    from points2surf_tpu.ops.voxel import grid_query_points

    pts = np.load(CLOUD)[:, :3].astype(np.float32)
    n = pts.shape[0]
    padded = np.zeros((-(-n // 16384) * 16384, 3), np.float32)
    padded[:n] = pts
    queries = grid_query_points(pts, 64, 3)[:256]

    rng = np.random.RandomState(0)
    m = JaxP2S(net_size_max=64, output_dim=2, shared_transformation=True)
    init = {"patch_pts_ps": jnp.asarray(rng.randn(16, 32, 3) * 0.3,
                                        jnp.float32),
            "pts_sub_sample_ms": jnp.asarray(rng.randn(16, 64, 3) * 0.3,
                                             jnp.float32),
            "imp_surf_query_point_ms": jnp.zeros((16, 3), jnp.float32)}
    v = m.init(jax.random.key(0), init, True)
    _, mut = m.apply(v, init, True, mutable=["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, mut["batch_stats"])

    monkeypatch.setenv("P2S_EVAL_APPROX_SELECT", "0")
    jax.clear_caches()
    key = jax.random.key(7)
    want = np.asarray(jax_query_fn(m, OUTPUTS, JaxCfg(**KW),
                                   fixed_radius=False)(
        params, stats, jnp.asarray(padded), jnp.asarray(queries),
        jnp.int32(n), key))
    monkeypatch.delenv("P2S_EVAL_APPROX_SELECT")
    jax.clear_caches()

    model = TorchP2S(net_size_max=64, output_dim=2,
                     shared_transformation=True)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    cfg = tp.PatchConfig(**KW)
    draws = jax_draws(key, len(queries), len(padded), cfg, False)
    fn = make_sdf_query_fn(model, OUTPUTS, cfg, fixed_radius=False)
    got = fn(torch.from_numpy(padded), torch.from_numpy(queries), n, draws)
    assert got.shape == (len(queries),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # two batches drained into one host array
    out = drain_batched_results([got[:128], got[128:]], 200)
    np.testing.assert_array_equal(out, got.numpy()[:200])
