"""The PointsToSurf dual-branch SDF regressor
(counterpart of ``points2surf_tpu/models/p2s.py``). ``model.train()`` runs
the train-mode graph (batch statistics, see ``models/pointnet.py``),
``model.eval()`` the eval graph.

Variants (mutually exclusive, reference points_to_surf_model.py:250-267):
  * vanilla: two encoders; the global branch's QSTN rotation is also
    applied to the local patch;
  * shared_transformation: one QSTN consumes both point sets concatenated
    and rotates both;
  * single_transformer: one encoder consumes both point sets concatenated.

``dtype=torch.bfloat16`` runs the activations in bf16 with fp32 parameters
(the JAX package's ``dtype``; ``models/pointnet.py``); the output is then
bf16, and the train step casts it to fp32 for the losses.

On a grid with a ``model`` axis (``parallel/sharding.partition_params``)
the head's wide layers run column-parallel as the encoders' do
(``models/pointnet._dense``).
"""

from __future__ import annotations

import torch
from torch import nn

from points2surf_tpu_torch.models.pointnet import (
    BN, PLinear, PointNetFeat, QSTN, _dense, set_act_dtype)
from points2surf_tpu_torch.ops import geometry


class PointsToSurfModel(nn.Module):
    def __init__(self, net_size_max: int = 1024, output_dim: int = 2,
                 use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max", single_transformer: bool = False,
                 shared_transformation: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.act_dtype = dtype
        self.single_transformer = single_transformer
        self.shared_transformation = shared_transformation
        self.use_point_stn = use_point_stn
        if single_transformer:
            self.feat_local_global = PointNetFeat(
                net_size_max, net_size_max, use_point_stn, use_feat_stn,
                sym_op)
            self.fc1_local_global = PLinear(net_size_max, net_size_max,
                                            conv=False)
            self.bn1_local_global = BN(net_size_max)
        else:
            if use_point_stn and shared_transformation:
                self.point_stn = QSTN(net_size_max)
            self.feat_global = PointNetFeat(
                net_size_max, net_size_max,
                use_point_stn and not shared_transformation, use_feat_stn,
                sym_op)
            self.fc1_global = PLinear(net_size_max, net_size_max // 2,
                                      conv=False)
            self.bn1_global = BN(net_size_max // 2)
            self.feat_local = PointNetFeat(net_size_max, net_size_max, False,
                                           use_feat_stn, sym_op)
            self.fc1_local = PLinear(net_size_max, net_size_max // 2,
                                     conv=False)
            self.bn1_local = BN(net_size_max // 2)
        self.fc2 = PLinear(net_size_max, net_size_max // 4, conv=False)
        self.bn2 = BN(net_size_max // 4)
        self.fc3 = PLinear(net_size_max // 4, net_size_max // 8, conv=False)
        self.bn3 = BN(net_size_max // 8)
        self.fc4 = PLinear(net_size_max // 8, output_dim, conv=False)
        set_act_dtype(self, dtype)

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: patch_pts_ps (B, P, 3), pts_sub_sample_ms (B, S, 3),
        imp_surf_query_point_ms (B, 3). Returns (B, output_dim) raw
        predictions (before post-processing)."""
        patch = batch["patch_pts_ps"]
        # center the global sub-sample at the query point (reference :302-303)
        sub = batch["pts_sub_sample_ms"] - batch["imp_surf_query_point_ms"][:, None, :]

        if self.single_transformer:
            both = torch.cat([patch, sub], dim=1)
            feat = self.feat_local_global(both)[0]
            h = _dense(feat, self.fc1_local_global, self.bn1_local_global,
                       act_relu=True)
        else:
            if self.use_point_stn and self.shared_transformation:
                trans, _ = self.point_stn(torch.cat([patch, sub], dim=1))
                sub = geometry.transform_points(sub, trans)
                patch = geometry.transform_points(patch, trans)
            g, trans_global, _, _ = self.feat_global(sub)
            g = _dense(g, self.fc1_global, self.bn1_global, act_relu=True)
            if self.use_point_stn and not self.shared_transformation:
                # rotate the local patch like the global sub-sample (:337-339)
                patch = geometry.transform_points(patch, trans_global)
            l = self.feat_local(patch)[0]
            l = _dense(l, self.fc1_local, self.bn1_local, act_relu=True)
            h = torch.cat([l, g], dim=1)

        h = _dense(h, self.fc2, self.bn2, act_relu=True)
        h = _dense(h, self.fc3, self.bn3, act_relu=True)
        return _dense(h, self.fc4)
