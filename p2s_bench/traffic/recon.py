"""Reconstruction traffic: ``full_eval --reconstruction`` of the workload's
shapes, back to back in a fixed order, in a closed loop.

Per shape visit the window runs the program's own functions, as
``cli/full_eval`` runs a shape: the grid queries' upload; the sweep (one
``infer/query.make_sdf_query_fn`` call per batch, every batch queued, the
last one padded with its first query); the fetch
(``drain_batched_results``); then ``infer/evaluator._save_shape`` on a
writer thread, as ``points_to_surf_eval`` runs it, and the stages of
``infer/meshing.implicit_surface_to_mesh_directory`` for one shape: the
volume (``_device_volume``), the debug volume OFF on a writer thread
(``_write_debug_volume``), marching and the mesh PLY
(``_extract_and_write``). Outputs go under the run's ``TMPDIR``, each
shape's overwritten by its next visit. The window stops issuing query
batches at its deadline; a visit whose sweep finished runs its other stages
to the end, and the window waits for the writer threads, so the rate does
not jump with where the deadline falls.

The grid queries (``ops/voxel.grid_query_points``, what
``ShapeStore(reconstruction=True)`` computes) and the padded clouds are
made in set-up. The weights come from the workload's ``weight_seed``; the
seed changes the draws, not the weights, the shapes or their order: each
batch's draws come from a generator seeded by (seed, visit, batch), so
the check can make them again after the window.
"""

from __future__ import annotations

import math
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from reference import data as ref_data
from reference import model as ref_model
from reference import volume as ref_volume

WARM_SEED = 12345
# a row whose reference sign logit lies within this share of the median
# logit's size of 0 has a sign decided by rounding: left out, as a row
# whose selection is ambiguous (reference/data.py's TIE)
SIGN_TIE = 1e-4


def _mix(seed: int, visit: int, batch: int) -> int:
    return (seed * 2 ** 20 + visit * 2 ** 12 + batch) % (2 ** 63)


class Traffic:
    checks = ("dist_err", "grid_diff", "vol_diff")
    end_to_end = "recon_queries_per_s"

    def __init__(self, ctx):
        from points2surf_tpu_torch.data.shapes import ShapeStore
        from points2surf_tpu_torch.infer.query import make_sdf_query_fn
        from points2surf_tpu_torch.models.p2s import PointsToSurfModel
        from points2surf_tpu_torch.ops import voxel
        from points2surf_tpu_torch.ops.patches import PatchConfig

        self.ctx = ctx
        cfg, p = ctx.cfg, ctx.workload["params"]
        self.cfg, self.params = cfg, p
        self.dev = torch.device(ctx.device)
        ev = cfg["eval"]
        self.batch, self.res = ev["batch_size"], ev["grid_resolution"]
        self.depth = ev["subsample_candidates"]
        m = cfg["model"]
        ref = ref_model.P2S(m)
        self.gen = torch.Generator(device=self.dev)
        # one set of weights for every seed: a seed's own weights would give
        # each seed its own volumes and meshes, and so its own work
        self.gen.manual_seed(p["weight_seed"])
        self.weights = ref_model.seeded_weights(ref, self.gen)
        model = PointsToSurfModel(
            net_size_max=m["net_size"], output_dim=m["output_dim"],
            use_point_stn=m["use_point_stn"], use_feat_stn=m["use_feat_stn"],
            sym_op=m["sym_op"], single_transformer=m["single_transformer"],
            shared_transformation=m["shared_transformation"])
        ctx.load_weights(model, self.weights)
        self.model = model.to(self.dev).eval()
        pc = cfg["patch"]
        self.patch_cfg = PatchConfig(
            points_per_patch=pc["points_per_patch"],
            patch_radius=pc["patch_radius"],
            sub_sample_size=pc["sub_sample_size"],
            uniform_subsample=pc["uniform_subsample"],
            fixed_subsample=pc["fixed_subsample"],
            subsample_candidates=self.depth)
        self.query_fn = make_sdf_query_fn(
            self.model, tuple(cfg["outputs"]), self.patch_cfg,
            fixed_radius=pc["patch_radius"] > 0.0, augment=False,
            coherent=True)

        root = ctx.root / p["dataset"]
        names = list(p["shapes"])
        listing = ctx.out / "shapes.txt"
        listing.write_text("\n".join(names) + "\n")
        store = ShapeStore(str(root), str(listing), with_query=False,
                           cache_capacity=len(names), device=self.dev)
        self.names = names
        self.root = root
        self.clouds = [store.device_points(i) for i in range(len(names))]
        self.grids = [voxel.grid_query_points(
            store.get(i).pts, self.res, ev["epsilon"], device=self.dev)
            for i in range(len(names))]
        self.eval_opt = types.SimpleNamespace(reconstruction=True)
        self.saver = ThreadPoolExecutor(max_workers=1)  # the evaluator's
        self.writer = ThreadPoolExecutor(max_workers=2)  # the mesh driver's
        self.futures = []
        self._warm()

    # -- the program's calls ------------------------------------------------

    def _draws(self, visit: int, bi: int, n_pad: int, n_valid: int,
               seed: int | None = None):
        from points2surf_tpu_torch.ops.patches import SubsampleDraws

        self.gen.manual_seed(_mix(self.ctx.seed if seed is None else seed,
                                  visit, bi))
        d = ref_data.make_draws(self.gen, self.batch, n_pad, n_valid,
                                self.cfg["patch"], self.depth, train=False)
        return SubsampleDraws(d["offset"], d["logu"], ids=d["ids"])

    def _batch_queries(self, q_all: torch.Tensor, bi: int) -> torch.Tensor:
        q = q_all[bi * self.batch:(bi + 1) * self.batch]
        if len(q) < self.batch:
            q = torch.cat([q, q[:1].expand(self.batch - len(q), 3)])
        return q

    def _visit_stages(self, grid: np.ndarray, dist: np.ndarray,
                      name: str) -> tuple[np.ndarray, np.ndarray, bool]:
        """A visit's stages after the fetch, through the program's own
        functions, as ``full_eval --reconstruction`` runs them: the
        evaluator's ``_save_shape`` on its writer thread (NaN -> 1, the
        queries and distances ``.npy``, the coloured query PLY); then, as
        ``implicit_surface_to_mesh_directory`` runs a shape, the volume
        (``_device_volume``), the debug volume OFF on a writer thread
        (``_write_debug_volume``), marching and the mesh PLY
        (``_extract_and_write``). Returns (the distances the mesh stage
        reads back, the volume, whether a mesh was written)."""
        from points2surf_tpu_torch.infer import evaluator, meshing

        ev, out = self.cfg["eval"], self.ctx.out
        self.futures.append(self.saver.submit(
            self._span, "write", evaluator._save_shape, name, grid, dist,
            self.eval_opt, str(out)))
        # what the mesh stage reads back from _save_shape's file
        dist = np.where(np.isnan(dist), 1.0, dist)
        with self.ctx.spans("volume"):
            vol = meshing._device_volume(grid, dist, self.res, ev["sigma"],
                                         ev["certainty_threshold"], 0,
                                         self.dev)
        self.futures.append(self.writer.submit(
            self._span, "write", meshing._write_debug_volume, grid, dist,
            str(out / "vol" / f"{name}.off")))
        with self.ctx.spans("marching"):
            meshed = meshing._extract_and_write(
                vol, str(out / "mesh" / f"{name}.ply"), self.res, grid)
        return dist, vol, meshed

    def _span(self, name: str, fn, *args):
        with self.ctx.spans(name):
            return fn(*args)

    def _drain_writers(self) -> None:
        """Wait for every write the writer threads hold (their errors
        surface here)."""
        futures, self.futures = self.futures, []
        for f in futures:
            f.result()

    def _warm(self) -> None:
        """One batch per shape, and one visit's stages after the fetch on a
        plane's distances over a batch of the first grid's queries (the
        volume and marching run at the full grid all the same), so that
        nothing loads or compiles in the window."""
        for si, (pts, nv) in enumerate(self.clouds):
            q = self._batch_queries(torch.from_numpy(self.grids[si]).to(
                self.dev), 0)
            self.query_fn(pts, q, nv, self._draws(0, si, pts.shape[0], nv,
                                                  seed=WARM_SEED))
        grid = self.grids[0][:self.batch]
        dist = (grid[:, 0] - float(np.median(grid[:, 0]))).astype(np.float32)
        self._visit_stages(grid, dist, "warm")
        self._drain_writers()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window ---------------------------------------------------------

    def window(self, seconds: float) -> dict:
        from points2surf_tpu_torch.infer.query import drain_batched_results

        spans, dev, b = self.ctx.spans, self.dev, self.batch
        self.visits = []  # (shape index, distances, volume)
        self.partial = None  # (visit, shape, pending results)
        queries = batches = meshes = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        visit = 0
        while True:
            si = visit % len(self.names)
            grid, (pts, nv) = self.grids[si], self.clouds[si]
            with spans("queries"):
                q_all = torch.from_numpy(grid).to(dev)
            pending = []
            with spans("sweep"):
                for bi in range(math.ceil(len(grid) / b)):
                    if time.perf_counter() >= deadline:
                        break
                    pending.append(self.query_fn(
                        pts, self._batch_queries(q_all, bi), nv,
                        self._draws(visit, bi, pts.shape[0], nv)))
            batches += len(pending)
            if len(pending) * b < len(grid):  # the window closed mid-sweep
                queries += len(pending) * b
                if pending:
                    self.partial = (visit, si, pending)
                    with spans("fetch"):  # the partial sweep's end
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                break
            queries += len(grid)
            with spans("fetch"):
                dist = drain_batched_results(pending, len(grid))
            dist, vol, meshed = self._visit_stages(grid, dist,
                                                   self.names[si])
            meshes += int(meshed)
            self.visits.append((si, dist, vol))
            visit += 1
        with spans("wait"):
            self._drain_writers()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        self.counters = {"queries": queries, "batches": batches,
                         "batch_size": b, "visits": len(self.visits),
                         "meshes": meshes, "window_s": window_s}
        return {"window_s": window_s, "work": queries,
                self.end_to_end: queries / window_s}

    def free(self) -> None:
        """Drop the program's model and cached clouds; keep the outputs the
        check reads (the distances, volumes and the partial visit's
        results, fetched)."""
        if self.partial is not None:
            visit, si, pending = self.partial
            self.partial = (visit, si, torch.cat(pending).cpu().numpy())
        self.saver.shutdown()
        self.writer.shutdown()
        del self.model, self.query_fn
        self.clouds = None

    # -- the check ----------------------------------------------------------

    def check(self, tf32: bool = False) -> list[tuple[str, float]]:
        """The compared numbers, (name, value), each at most its limit. The
        signed distances of a sample of the window's batches (drawn from the
        seed) against the reference's on the same queries and draws, the
        widest gap over the reference's patch radius, rows whose selection
        or sign rounding decides left out; each shape's grid against the
        reference's; one visit's volume against the reference's volume of
        the program's distances. With ``tf32`` the reference in TF32 stands in the
        program's place (the control)."""
        dev, b = self.dev, self.batch
        rng = np.random.default_rng(self.ctx.seed)
        ev = self.cfg["eval"]
        clouds = [ref_data.padded(np.load(self.root / "04_pts" /
                                          f"{n}.xyz.npy"), dev)
                  for n in self.names]
        grids = [ref_volume.grid_queries(c[0][:c[1]], self.res,
                                         ev["epsilon"]) for c in clouds]
        shown = {si for si, _, _ in self.visits}
        if self.partial is not None:
            shown.add(self.partial[1])
        grid_diff = 0
        for si in sorted(shown):
            got = torch.as_tensor(self.grids[si], device=dev)
            want = grids[si]
            grid_diff += (abs(len(got) - len(want)) if len(got) != len(want)
                          else int(torch.count_nonzero((got != want).any(1))))

        # every completed batch: (visit, shape, batch index, program rows)
        done = []
        for visit, (si, dist, _) in enumerate(self.visits):
            for bi in range(math.ceil(len(dist) / b)):
                done.append((visit, si, bi, dist[bi * b:(bi + 1) * b]))
        if self.partial is not None:
            visit, si, res = self.partial
            for bi in range(len(res) // b):
                rows = res[bi * b:(bi + 1) * b][:len(self.grids[si]) - bi * b]
                done.append((visit, si, bi, rows))
        take = rng.choice(len(done), min(len(done),
                                         self.params["check_batches"]),
                          replace=False)
        ref = ref_model.P2S(self.cfg["model"]).to(dev).eval()
        ref.load_state_dict(self.weights)
        dist_err = 0.0
        ties = 0
        for j in sorted(take):
            visit, si, bi, got = done[j]
            pts, nv = clouds[si]
            q = grids[si][bi * b:(bi + 1) * b]
            draws = self._draws(visit, bi, pts.shape[0], nv)
            draws = {"offset": draws.offset, "logu": draws.logu,
                     "ids": draws.ids}
            if len(q) < b:
                q = torch.cat([q, q[:1].expand(b - len(q), 3)])
            want, logit, radius, tie = _reference_sdf(
                ref, pts, nv, q, draws, self.cfg, self.depth, False)
            if tf32:
                got = _reference_sdf(ref, pts, nv, q, draws, self.cfg,
                                     self.depth, True)[0]
            got = torch.as_tensor(np.asarray(got.cpu() if tf32 else got),
                                  device=dev)
            n = len(got)
            sure = ~tie[:n] & (logit[:n].abs()
                               >= SIGN_TIE * torch.median(logit.abs()))
            err = torch.abs(got[sure] - want[:n][sure]) / radius[:n][sure]
            dist_err = max(dist_err, float(torch.max(err)))
            ties += int(torch.count_nonzero(~sure))

        vol_diff = 0
        if self.visits:
            si, dist, vol = self.visits[rng.integers(len(self.visits))]
            want = ref_volume.volume(grids[si], torch.as_tensor(dist,
                                                                device=dev),
                                     self.res, ev["sigma"],
                                     ev["certainty_threshold"])
            vol_diff = int(torch.count_nonzero(
                torch.as_tensor(vol, device=dev) != want))
        self.tie_rows = ties
        return [("dist_err", dist_err), ("grid_diff", float(grid_diff)),
                ("vol_diff", float(vol_diff))]


def _reference_sdf(ref, pts, nv, q, draws, cfg, depth, tf32, rows=128):
    """(signed distances, sign logits, patch radii, rows whose selection is
    ambiguous to rounding) of the reference on the batch ``q`` with its
    draws, ``rows`` queries at a time."""
    out = []
    with torch.no_grad():
        for s in range(0, len(q), rows):
            d = {k: (v[s:s + rows] if v is not None and v.dim() else v)
                 for k, v in draws.items()}
            patch_ps, radius, sub, qm, tie = ref_data.patches(
                pts, nv, q[s:s + rows], d, cfg["patch"], depth, train=False,
                tf32=tf32, ties=True)
            pred = ref(patch_ps, sub, qm, tf32)
            out.append((ref_data.signed_distance(pred, radius), pred[:, 1],
                        radius, tie))
    return tuple(torch.cat(t) for t in zip(*out))
