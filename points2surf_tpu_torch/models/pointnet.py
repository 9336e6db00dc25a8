"""PointNet encoders with spatial transformers, eval mode
(counterpart of ``points2surf_tpu/models/pointnet.py``).

Points are channels-last (B, n, C), as in the JAX package. Module and
parameter names reproduce the reference torch ``state_dict`` layout that
``points2surf_tpu.models.import_torch.export_state_dict`` emits (conv
weights (out, in, 1), Linear weights (out, in), BatchNorm weight / bias /
running statistics), so a released ``.pth`` loads with ``strict=True``.

Every trunk and encoder tail is a chain ``conv1 -> bn1 -> relu -> conv2 ->
bn2 -> relu -> conv3 -> bn3 -> pool``; at eval its BatchNorms are known
affines, so the whole chain runs as one ``chain_pool`` call on folded
``(W, a, c)`` triples (the CUDA kernel on a GPU). Train mode and the
multi-scale branch come with later slices and raise here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool, fold_conv_bn


class PLinear(nn.Module):
    """Pointwise linear layer on channels-last input.

    ``conv=True`` holds a torch ``Conv1d(k=1)`` weight (out, in, 1),
    otherwise a ``Linear`` weight (out, in); both with torch's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init."""

    def __init__(self, in_features: int, out_features: int, conv: bool):
        super().__init__()
        shape = (out_features, in_features) + ((1,) if conv else ())
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_features))
        bound = 1.0 / math.sqrt(in_features)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def kernel(self) -> torch.Tensor:
        """(in, out) matrix view of the weight."""
        return self.weight.reshape(self.weight.shape[0], -1).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel()) + self.bias


def _require_eval(bn: nn.Module) -> None:
    if bn.training:
        raise NotImplementedError(
            "train-mode BatchNorm is not ported yet; call .eval()")


class BN(nn.BatchNorm1d):
    """BatchNorm with the running statistics of torch ``BatchNorm1d``
    (eps 1e-5), applied to channels-last input. Eval mode only."""

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(a, c) with ``bn(y) == y * a + c`` under the running statistics."""
        _require_eval(self)
        return fold_conv_bn(torch.zeros_like(self.bias), self.weight,
                            self.bias, self.running_mean, self.running_var,
                            self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, c = self.eval_affine()
        return x * a + c


def _chain_layer(conv: PLinear, bn: BN):
    """Folded (W, a, c) triple of one conv + eval-BN layer."""
    _require_eval(bn)
    a, c = fold_conv_bn(conv.bias, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)
    return conv.kernel().contiguous(), a, c


def _conv_bn_relu(x, conv: PLinear, bn: BN):
    return torch.relu(bn(conv(x)))


def _single_scale(num_scales: int) -> None:
    if num_scales != 1:
        raise NotImplementedError("the multi-scale branch is not ported yet")


class _STNTrunk(nn.Module):
    """Conv trunk + FC head shared by STN and QSTN (reference
    model.py:41-64, 100-122)."""

    def __init__(self, in_features: int, net_size_max: int,
                 out_features: int, num_scales: int = 1):
        super().__init__()
        _single_scale(num_scales)
        self.conv1 = PLinear(in_features, 64, conv=True)
        self.conv2 = PLinear(64, 128, conv=True)
        self.conv3 = PLinear(128, net_size_max, conv=True)
        self.fc1 = PLinear(net_size_max, net_size_max // 2, conv=False)
        self.fc2 = PLinear(net_size_max // 2, net_size_max // 4, conv=False)
        self.fc3 = PLinear(net_size_max // 4, out_features, conv=False)
        self.bn1 = BN(64)
        self.bn2 = BN(128)
        self.bn3 = BN(net_size_max)
        self.bn4 = BN(net_size_max // 2)
        self.bn5 = BN(net_size_max // 4)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        layers = (_chain_layer(self.conv1, self.bn1),
                  _chain_layer(self.conv2, self.bn2),
                  _chain_layer(self.conv3, self.bn3))
        # the transformers pool with max whatever the encoder's sym_op; the
        # post-bn3 relu commutes with the max
        h = torch.relu(chain_pool(x.contiguous(), layers, sym_op="max"))
        h = torch.relu(self.bn4(self.fc1(h)))
        h = torch.relu(self.bn5(self.fc2(h)))
        return self.fc3(h)


class STN(_STNTrunk):
    """Feature transformer: (B, n, dim) -> (B, dim, dim) matrix + identity."""

    def __init__(self, net_size_max: int = 1024, dim: int = 64,
                 num_scales: int = 1):
        super().__init__(dim, net_size_max, dim * dim, num_scales)
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x)
        iden = torch.eye(self.dim, dtype=h.dtype, device=h.device).reshape(-1)
        return (h + iden).reshape(x.shape[0], self.dim, self.dim)


class QSTN(_STNTrunk):
    """Quaternion point transformer: (B, n, 3) -> rotation (B, 3, 3) and the
    quaternion (B, 4); a zero network output is the identity."""

    def __init__(self, net_size_max: int = 1024, num_scales: int = 1):
        super().__init__(3, net_size_max, 4, num_scales)

    def forward(self, x: torch.Tensor):
        h = self.trunk(x)
        quat = h + torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=h.dtype,
                                device=h.device)
        return geometry.quat_to_rotmat(quat), quat


class PointNetFeat(nn.Module):
    """Shared-MLP point encoder (reference model.py:134-234): optional QSTN
    rotation -> MLP(64, 64) -> optional 64-d feature STN -> MLP(64, 128,
    output_size) -> max or sum pool. (B, n, 3) -> (B, output_size)."""

    def __init__(self, net_size_max: int = 1024, output_size: int = 1024,
                 use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max", num_scales: int = 1):
        super().__init__()
        _single_scale(num_scales)
        if sym_op not in ("max", "sum"):
            raise ValueError(f"Unsupported symmetric operation: {sym_op}")
        self.sym_op = sym_op
        self.stn1 = QSTN(net_size_max) if use_point_stn else None
        self.conv0a = PLinear(3, 64, conv=True)
        self.conv0b = PLinear(64, 64, conv=True)
        self.bn0a = BN(64)
        self.bn0b = BN(64)
        self.stn2 = STN(net_size_max, 64) if use_feat_stn else None
        self.conv1 = PLinear(64, 64, conv=True)
        self.conv2 = PLinear(64, 128, conv=True)
        self.conv3 = PLinear(128, output_size, conv=True)
        self.bn1 = BN(64)
        self.bn2 = BN(128)
        self.bn3 = BN(output_size)

    def forward(self, x: torch.Tensor):
        trans = trans_quat = trans2 = None
        if self.stn1 is not None:
            trans, trans_quat = self.stn1(x)
            x = geometry.transform_points(x, trans)
        h = _conv_bn_relu(x, self.conv0a, self.bn0a)
        h = _conv_bn_relu(h, self.conv0b, self.bn0b)
        if self.stn2 is not None:
            trans2 = self.stn2(h)
            # einsum("bij,bnj->bni"), in fp32
            h = torch.bmm(h, trans2.transpose(1, 2))
        layers = (_chain_layer(self.conv1, self.bn1),
                  _chain_layer(self.conv2, self.bn2),
                  _chain_layer(self.conv3, self.bn3))
        # no relu after bn3 in the single-scale encoder (model.py:209-230)
        h = chain_pool(h.contiguous(), layers, sym_op=self.sym_op)
        return h, trans, trans_quat, trans2
