"""Reconstruction traffic in ball mode: ``traffic/recon.py``'s window, stages,
writers and checks for a configuration with ``patch_radius > 0``.

Each batch's draws add the keyed ball priorities (``ops/patches.BallDraws.
keyed``): one key per batch, drawn after the sub-sample's numbers from the
same device generator seeded by (seed, visit, batch), so the key never
crosses from the host. The check holds the program's distances to
``reference/ball.py``'s, which selects from the same key, each row keyed by
its row in the batch.

``dist_err``'s limit in ``workloads/p2s_small_radius.recon.json`` is 2e-5.
A fixed-radius distance is ``tanh(p0)^2`` with the sign, not scaled by r,
so its float32 rounding over r = 0.05 reads 20 times what a kNN cell's
does: the program read 1.8e-7 to 2.3e-7 on 22 seeds on an H100 (89x under
the limit), the reference in TF32 1.4e-3 to 2.2e-3 (68x over it).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

import harness
from reference import ball as ref_ball
from reference import data as ref_data
from reference import model as ref_model
from reference import volume as ref_volume

recon = harness.traffic("recon")


class Traffic(recon.Traffic):
    def _draws(self, visit: int, bi: int, n_pad: int, n_valid: int,
               seed: int | None = None):
        from points2surf_tpu_torch.ops.patches import BallDraws

        d = super()._draws(visit, bi, n_pad, n_valid, seed)
        key = torch.randint(0, 2 ** 32, (), generator=self.gen,
                            device=self.dev)
        return dataclasses.replace(d, ball=BallDraws.keyed(key))

    def check(self, tf32: bool = False) -> list[tuple[str, float]]:
        """``recon.Traffic.check`` with ``reference/ball.py``'s patches and
        its fixed-radius distances: ``dist_err`` is the widest gap over the
        fixed radius, rows whose result rounding decides left out; with
        ``tf32`` the reference in TF32 stands in the program's place (the
        control). Says on standard error how many rows were left out and
        what share of the checked patch slots are pads."""
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
        ties = rows_checked = pads = slots = 0
        for j in sorted(take):
            visit, si, bi, got = done[j]
            pts, nv = clouds[si]
            q = grids[si][bi * b:(bi + 1) * b]
            draws = self._draws(visit, bi, pts.shape[0], nv)
            key = draws.ball.key
            draws = {"offset": draws.offset, "logu": draws.logu,
                     "ids": draws.ids}
            if len(q) < b:
                q = torch.cat([q, q[:1].expand(b - len(q), 3)])
            want, logit, radius, tie, pad = _reference_sdf(
                ref, pts, nv, q, key, draws, self.cfg, self.depth, False)
            if tf32:
                got = _reference_sdf(ref, pts, nv, q, key, draws, self.cfg,
                                     self.depth, True)[0]
            got = torch.as_tensor(np.asarray(got.cpu() if tf32 else got),
                                  device=dev)
            n = len(got)
            sure = ~tie[:n] & (logit[:n].abs() >= recon.SIGN_TIE
                               * torch.median(logit.abs()))
            err = torch.abs(got[sure] - want[:n][sure]) / radius[:n][sure]
            dist_err = max(dist_err, float(torch.max(err)))
            ties += int(torch.count_nonzero(~sure))
            rows_checked += n
            pads += int(pad[:n].sum())
            slots += n * self.cfg["patch"]["points_per_patch"]

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
        self.pad_share = pads / max(slots, 1)
        print(f"ball check: {ties} of {rows_checked} rows left out as TIE; "
              f"{pads} of {slots} patch slots padded "
              f"({self.pad_share:.4%})", file=sys.stderr)
        return [("dist_err", dist_err), ("grid_diff", float(grid_diff)),
                ("vol_diff", float(vol_diff))]


def _reference_sdf(ref, pts, nv, q, key, draws, cfg, depth, tf32, rows=128):
    """(signed distances, sign logits, patch radii, rows whose result
    rounding decides, pad slots per row) of the ball-mode reference on the
    batch ``q`` with its key and sub-sample draws, ``rows`` queries at a
    time; each row keyed by its row in the batch."""
    out = []
    with torch.no_grad():
        for s in range(0, len(q), rows):
            d = {k: (v[s:s + rows] if v is not None and v.dim() else v)
                 for k, v in draws.items()}
            at = torch.arange(s, min(s + rows, len(q)), device=q.device)
            patch_ps, radius, sub, qm, tie, pad = ref_ball.patches(
                pts, nv, q[s:s + rows], at, key, d, cfg["patch"], depth,
                tf32=tf32)
            pred = ref(patch_ps, sub, qm, tf32)
            out.append((ref_ball.fixed_radius_distance(pred), pred[:, 1],
                        radius, tie, pad))
    return tuple(torch.cat(t) for t in zip(*out))
