"""Evaluation / reconstruction driver (counterpart of
``points2surf_tpu/infer/evaluator.py``; reference
source/points_to_surf_eval.py).

Evaluates the trained SDF regressor over GT query points (eval mode) or over
all near-surface grid voxel centers (reconstruction mode). The inner loop is
the fused SDF query (``infer/query.py``): per shape, fixed-size query
batches go through patch extraction, the eval forward and post-processing
on the device, and each shape's model-space distances are fetched once.

Under a process group the shapes go round-robin over the ranks (the JAX
package's per-shape split over hosts): each rank evaluates and writes its
own shapes, its draws advancing per batch that it runs.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from points2surf_tpu_torch.data.shapes import ShapeStore
from points2surf_tpu_torch.device import require_cuda
from points2surf_tpu_torch.infer.query import (
    drain_batched_results,
    make_sdf_query_fn,
)
from points2surf_tpu_torch.models.weights import load_reference_pth
from points2surf_tpu_torch.ops.patches import PatchConfig, draw_batch
from points2surf_tpu_torch.parallel import distributed
from points2surf_tpu_torch.train import checkpoint as ckpt
from points2surf_tpu_torch.train.trainer import build_model, output_spec
from points2surf_tpu_torch.utils import file_utils, mesh_io, trace


def visualize_query_points(query_pts_ms, query_dist_ms, file_out):
    """Red = outside, green = inside colored cloud (reference sdf.py:269-285)."""
    dist_abs = np.abs(query_dist_ms)
    dist_norm = dist_abs / max(float(dist_abs.max()), 1e-12)
    colors = np.zeros((query_dist_ms.shape[0], 3))
    neg = query_dist_ms < 0.0
    pos = query_dist_ms > 0.0
    colors[neg, 0] = 0.5 + 0.5 * dist_norm[neg]
    colors[pos, 1] = 0.5 + 0.5 * dist_norm[pos]
    mesh_io.write_ply(file_out, query_pts_ms, colors=colors)


#: Eval-path default for the sub-sample's candidate decimation depth. 4
#: (against the training default of 8 in ``PatchConfig``) is the JAX
#: package's eval default, which passed its reconstruction-quality gate.
#: Override with P2S_SUBSAMPLE_CANDIDATES.
EVAL_SUBSAMPLE_CANDIDATES = 4


def _subsample_candidates_from_env() -> int:
    """Parse the P2S_SUBSAMPLE_CANDIDATES eval lever, falling back to the
    eval default (with a warning) on a non-integer value, and announcing a
    non-default depth so it is visible in the run output."""
    default = EVAL_SUBSAMPLE_CANDIDATES
    raw = os.environ.get("P2S_SUBSAMPLE_CANDIDATES")
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        print(f"WARNING: P2S_SUBSAMPLE_CANDIDATES={raw!r} is not an "
              f"integer; using default {default}")
        return default
    if value != default:
        print(f"eval lever: subsample_candidates={value} "
              f"(P2S_SUBSAMPLE_CANDIDATES, default {default})")
    return value


def post_process(pred: np.ndarray, outputs, patch_radius, fixed_radius):
    """tanh^2 scaling back to model space + sign binarization
    (reference points_to_surf_eval.py:174-196). Kept for API parity and
    tests; the fused query applies the same math on the device."""
    pred = np.asarray(pred).copy()
    dim = 0
    for o in outputs:
        if o == "imp_surf":
            d = np.tanh(pred[:, dim]) ** 2 * np.sign(pred[:, dim])
            if not fixed_radius:
                d = d * patch_radius
            pred[:, dim] = d
            dim += 1
        elif o == "imp_surf_magnitude":
            m = np.tanh(pred[:, dim]) ** 2
            if not fixed_radius:
                m = m * patch_radius
            pred[:, dim] = m
            dim += 1
        elif o == "imp_surf_sign":
            pred[:, dim] = np.where(pred[:, dim] >= 0.0, 1.0, -1.0)
            dim += 1
    return pred


def load_model_for_eval(eval_opt, model_name, device="cuda"):
    """Params (JSON, or a reference ``*_params.pth`` namespace) and weights
    (an ``.npz`` in the JAX package's layout, or a reference ``.pth`` state
    dict) -> (model in eval mode on ``device``, train_opt)."""
    model_file = os.path.join(
        eval_opt.modeldir, model_name + eval_opt.modelpostfix
    )
    param_file = os.path.join(
        eval_opt.modeldir, model_name + eval_opt.parampostfix
    )
    if param_file.endswith(".pth"):
        # the reference pickles its argparse namespace
        train_opt = torch.load(param_file, map_location="cpu",
                               weights_only=False)
    else:
        train_opt = ckpt.load_params_namespace(param_file)
    # backward-compat defaults (reference eval.py:317-320)
    for attr, default in (
        ("single_transformer", 0),
        ("shared_transformer", 0),
        ("uniform_subsample", 0),
        ("fixed_subsample", 0),
        ("net_size", 1024),
    ):
        if not hasattr(train_opt, attr):
            setattr(train_opt, attr, default)

    pred_dim, _, _ = output_spec(train_opt.outputs)
    # the inference activation dtype: --eval_dtype, with 'auto'
    # P2S_EVAL_DTYPE, with 'auto' again the checkpoint's training dtype;
    # parameters stay float32
    dtype = getattr(eval_opt, "eval_dtype", "auto")
    if dtype == "auto":
        dtype = os.environ.get("P2S_EVAL_DTYPE", "auto")
    if dtype not in ("float32", "bfloat16"):
        dtype = getattr(train_opt, "train_dtype", "float32")
    model = build_model(
        argparse.Namespace(**{**vars(train_opt), "train_dtype": dtype}),
        pred_dim)

    if model_file.endswith(".pth"):
        load_reference_pth(model, model_file)
    else:
        keys = ckpt.model_state(model).keys()
        ckpt.load_model_state(model, ckpt.load_state(model_file, keys))
    return model.to(require_cuda(device)).eval(), train_opt


def points_to_surf_eval(eval_opt, device="cuda", shard=None):
    """Evaluate (or, with ``eval_opt.reconstruction``, reconstruct) the
    shapes of ``eval_opt.dataset`` with each model of ``eval_opt.models`` on
    ``device`` ("cuda" unless the caller asks for the CPU).

    ``shard=(index, count)`` takes the shapes whose position in the dataset
    is ``index`` modulo ``count``; None takes this data rank's share of
    the process group (every shape without one). The model ranks of a data
    rank evaluate the same shapes, and only model rank 0 writes them."""
    device = require_cuda(device)
    proc, n_proc = shard or (distributed.data_rank(),
                             distributed.data_size())
    writes = distributed.model_rank() == 0
    models = eval_opt.models.split()

    for model_name in models:
        print(f"Random Seed: {eval_opt.seed}")
        model, train_opt = load_model_for_eval(eval_opt, model_name, device)
        batch_size = (
            eval_opt.batchSize if eval_opt.batchSize else train_opt.batchSize
        )
        fixed_radius = train_opt.patch_radius > 0.0

        store = ShapeStore(
            eval_opt.indir,
            eval_opt.dataset,
            with_query=True,
            reconstruction=bool(eval_opt.reconstruction),
            query_grid_resolution=eval_opt.query_grid_resolution,
            epsilon=eval_opt.epsilon,
            cache_capacity=eval_opt.cache_capacity,
            device=device,
        )
        patch_cfg = PatchConfig(
            points_per_patch=train_opt.points_per_patch,
            patch_radius=train_opt.patch_radius,
            sub_sample_size=train_opt.sub_sample_size,
            uniform_subsample=bool(train_opt.uniform_subsample),
            fixed_subsample=bool(train_opt.fixed_subsample),
            exact=bool(getattr(eval_opt, "exact_patch_sampling", 0)),
            subsample_candidates=_subsample_candidates_from_env(),
        )
        # the reference augments any non-reconstruction pass
        # (data_loader.py:381-393)
        augment = not eval_opt.reconstruction
        query_fn = make_sdf_query_fn(
            model, tuple(train_opt.outputs), patch_cfg, fixed_radius,
            augment=augment,
            # reconstruction grids are Morton-ordered (tiles certify);
            # GT eval points are spread surface samples
            coherent=bool(eval_opt.reconstruction),
        )

        model_out_dir = os.path.join(
            eval_opt.outdir, "rec" if eval_opt.reconstruction else "eval"
        )
        os.makedirs(model_out_dir, exist_ok=True)

        rng = np.random.RandomState(eval_opt.seed)
        gen = torch.Generator(device=device).manual_seed(eval_opt.seed)
        if eval_opt.reconstruction:
            # patch counts are lazy in reconstruction mode (grid queries are
            # computed per shape on first touch) — don't force a full scan
            print(f"reconstructing {len(store.shape_names)} shapes")
        else:
            print(f"evaluating {store.total_patch_count} patches")
        # host-side result writing (colored vis PLYs are slow IO) runs on a
        # writer thread that handles numpy arrays only, so the device starts
        # the next shape at once
        with ThreadPoolExecutor(max_workers=1) as saver:
            save_futures = []
            for shape_ind, name in enumerate(store.shape_names):
                if shape_ind % n_proc != proc:
                    continue
                shape = store.get(shape_ind)
                pts_dev, n_valid = store.device_points(shape_ind)
                small = n_valid < max(train_opt.sub_sample_size, 1)
                queries = shape.query_pts
                patch_inds = None
                if eval_opt.sampling == "sequential_shapes_random_patches":
                    take = min(eval_opt.patches_per_shape, len(queries))
                    patch_inds = rng.choice(len(queries), take, replace=False)
                    queries = queries[patch_inds]
                elif eval_opt.sampling != "full":
                    raise ValueError(
                        f"Unknown sampling strategy: {eval_opt.sampling}"
                    )

                # every batch queued on the device, the last one padded with
                # its first query; one fetch per shape
                with trace.blocking(device):
                    q_all = torch.from_numpy(queries).to(device)
                pending = []
                for s in range(0, len(queries), batch_size):
                    q = q_all[s : s + batch_size]
                    if len(q) < batch_size:
                        q = torch.cat(
                            [q, q[:1].expand(batch_size - len(q), 3)])
                    draws = draw_batch(gen, batch_size, pts_dev.shape[0],
                                       patch_cfg, small, train=augment,
                                       n_valid=n_valid)
                    pending.append(query_fn(pts_dev, q, n_valid, draws,
                                            small_cloud=small))
                dists = drain_batched_results(pending, len(queries))
                if not writes:
                    continue
                save_futures.append(saver.submit(
                    _save_shape, name, queries, dists, eval_opt,
                    model_out_dir
                ))
                if patch_inds is not None:
                    np.savetxt(
                        os.path.join(model_out_dir, name + ".idx"),
                        patch_inds, fmt="%d",
                    )
            for f in save_futures:
                f.result()  # surface any writer exception


def _save_shape(name, queries, dist, eval_opt, model_out_dir):
    """Write per-shape predictions (reference eval.py:199-294).

    Takes plain arrays (the queries actually evaluated — subsampled when
    ``sequential_shapes_random_patches``) so it can run on a writer thread
    without touching the ShapeStore."""

    if eval_opt.reconstruction:
        # NaN -> 1.0 (tanh cannot produce > 1; reference eval.py:205-207)
        dist = np.where(np.isnan(dist), 1.0, dist)
        qdir = os.path.join(model_out_dir, "query_pts_ms")
        ddir = os.path.join(model_out_dir, "dist_ms")
        os.makedirs(qdir, exist_ok=True)
        os.makedirs(ddir, exist_ok=True)
        npys = (os.path.join(qdir, name + ".xyz.npy"),
                os.path.join(ddir, name + ".xyz.npy"))
        with trace.span("write.npy"):
            np.save(npys[0], queries)
            np.save(npys[1], dist)
        vdir = os.path.join(model_out_dir, "query_pts_ms_vis")
        os.makedirs(vdir, exist_ok=True)
        vis = os.path.join(vdir, name + ".ply")
        with trace.span("write.query_ply"):
            visualize_query_points(queries, dist, vis)
        trace.count_sizes("write.bytes", *npys, vis)
    else:
        edir = os.path.join(model_out_dir, "eval")
        os.makedirs(edir, exist_ok=True)
        outs = (os.path.join(edir, name + ".xyz.npy"),
                os.path.join(edir, name + ".xyz.txt"))
        with trace.span("write.npy"):
            np.save(outs[0], dist)
            np.savetxt(outs[1], dist)
        vis = os.path.join(model_out_dir, "vis", name + ".ply")
        file_utils.make_dir_for_file(vis)
        with trace.span("write.query_ply"):
            visualize_query_points(queries, dist, vis)
        trace.count_sizes("write.bytes", *outs, vis)
