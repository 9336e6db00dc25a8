"""PointNet encoders with spatial transformers
(counterpart of ``points2surf_tpu/models/pointnet.py``).

Points are channels-last (B, n, C), as in the JAX package. Module and
parameter names reproduce the reference torch ``state_dict`` layout that
``points2surf_tpu.models.import_torch.export_state_dict`` emits (conv
weights (out, in, 1), Linear weights (out, in), BatchNorm weight / bias /
running statistics), so a released ``.pth`` loads with ``strict=True``.

Every trunk and encoder tail is a chain ``conv1 -> bn1 -> relu -> conv2 ->
bn2 -> relu -> conv3 -> bn3 -> pool``.

* Eval: the BatchNorms are known affines, so the whole chain runs as one
  ``chain_pool`` call on folded ``(W, a, c)`` triples (the CUDA kernel on a
  GPU).
* Train (``module.train()``), as the JAX package computes it: every
  interior per-point layer takes the covariance form (batch statistics of
  ``x @ W + b`` from the Gram matrix and mean of x, then one matmul with
  the effective weights, autograd through it); the conv3 tail needs only
  per-(row, channel) reductions of ``c = x @ W + b`` (``pooled_tail``, the
  CUDA kernel on a GPU), with the hand-derived backward of
  ``_LinearPoolReductions``, which never forms a (B, n, C) tensor.

Both kernels have two numerics classes, which their wrappers choose at
each call from the JAX package's variables: ``P2S_EVAL_CHAIN_PREC`` for the
eval chains, ``P2S_PALLAS_TAIL_PREC`` for the train tails. Unset or
``highest`` is the fp32 class (the port's default); ``default`` rounds
every operand of the kernels' products to bf16 and accumulates in fp32
(the JAX package's default). Everything else here stays fp32, the train
tail's backward included: only the forward's reductions (and the ``mean``
saved for the backward) come from bf16 products.

BatchNorm in train mode follows flax: the biased batch variance normalizes
and updates the running variance, ``r = 0.9 r + 0.1 batch``. The
multi-scale branch raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool, fold_conv_bn
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_reductions)

BN_MOMENTUM = 0.9  # flax convention: weight of the old running statistic


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


class BN(nn.BatchNorm1d):
    """BatchNorm with the parameters and running statistics of torch
    ``BatchNorm1d`` (eps 1e-5), on channels-last input. Train mode is
    flax's ``nn.BatchNorm``: statistics over every axis but the last, the
    biased variance E[x^2] - E[x]^2 (clipped at 0), running statistics
    ``0.9 r + 0.1 batch`` (stock ``BatchNorm1d`` would update the running
    variance with the unbiased one)."""

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(a, c) with ``bn(y) == y * a + c`` under the running statistics."""
        return fold_conv_bn(torch.zeros_like(self.bias), self.weight,
                            self.bias, self.running_mean, self.running_var,
                            self.eps)

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            a, c = self.eval_affine()
            return x * a + c
        dims = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=dims)
        var = torch.clamp(torch.mean(x * x, dim=dims) - mean * mean, min=0.0)
        self.update_running_stats(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * inv + self.bias


def _chain_layer(conv: PLinear, bn: BN):
    """Folded (W, a, c) triple of one conv + eval-BN layer."""
    a, c = fold_conv_bn(conv.bias, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)
    return conv.kernel().contiguous(), a, c


def _conv_bn_relu(x, conv: PLinear, bn: BN):
    """Pointwise linear -> BatchNorm -> ReLU on (B, n, Cin). In train mode
    the covariance form of the JAX package (``_conv_bn_relu``): the batch
    statistics of ``y = x @ W + b`` are ``mean(x) @ W + b`` and
    ``diag(W^T Cov(x) W)``, and the layer is one matmul with the effective
    weights ``W * g / sigma``; autograd differentiates through it."""
    if not bn.training:
        return torch.relu(bn(conv(x)))
    k, b = conv.kernel(), conv.bias
    n_tot = x.shape[0] * x.shape[1]
    xf = x.reshape(n_tot, x.shape[2])
    xm = torch.sum(xf, dim=0) / n_tot
    gram = (xf.t() @ xf) / n_tot
    cov = gram - xm[:, None] * xm[None, :]
    mean_y = xm @ k + b
    var_y = torch.clamp(torch.sum(k * (cov @ k), dim=0), min=0.0)
    bn.update_running_stats(mean_y.detach(), var_y.detach())
    inv = bn.weight * torch.rsqrt(var_y + bn.eps)
    return torch.relu(x @ (k * inv) + (bn.bias + (b - mean_y) * inv))


class _LinearPoolReductions(torch.autograd.Function):
    """Pooled reductions of ``c = x @ w + b`` over the point axis (the JAX
    package's ``_linear_pool_reductions``): (max_n c, min_n c) or sum_n c,
    then the batch mean and biased variance of c over (B, n).

    The forward is the ``pooled_tail`` kernel. The backward is
    ``_lpr_bwd``: with N = B n, alpha = (g_mean - 2 mean g_var) / N and
    kappa = 2 g_var / N, dL/dc = (arg-row one-hots of g_max, g_min, or g_sum
    broadcast) + alpha + kappa c, pushed through the linear map
    analytically. The one-hot terms are gathers of x at the arg rows (for
    dW) and a scatter-add of g W^T into them (for dx): (B, C, Cin) tensors,
    never (B, n, C)."""

    @staticmethod
    def forward(ctx, x, w, b, need_minmax: bool):
        cmax, amax, cmin, amin, rsum, rsq = pooled_tail_reductions(x, w, b)
        n_tot = x.shape[0] * x.shape[1]
        mean = torch.sum(rsum, dim=0) / n_tot
        var = torch.sum(rsq, dim=0) / n_tot - mean * mean
        ctx.save_for_backward(x, w, b, amax, amin, mean)
        ctx.need_minmax = need_minmax
        if need_minmax:
            return cmax, cmin, mean, var
        return rsum, mean, var

    @staticmethod
    def backward(ctx, *grads):
        x, w, b, amax, amin, mean = ctx.saved_tensors
        gmean, gvar = grads[-2:]
        bsz, n, cin = x.shape
        n_tot = bsz * n
        alpha = (gmean - 2.0 * mean * gvar) / n_tot
        kappa = 2.0 * gvar / n_tot
        xf = x.reshape(n_tot, cin)
        xsum = torch.sum(xf, dim=0)
        wt = w.t()
        # dense terms of the BN statistics
        gram_k = (w * kappa) @ wt
        vec = alpha @ wt + (b * kappa) @ wt
        grad_x = (xf @ gram_k + vec).reshape(bsz, n, cin)
        grad_w = (xsum[:, None] * alpha
                  + ((xf.t() @ xf) @ w + xsum[:, None] * b) * kappa)
        grad_b = n_tot * alpha + kappa * (n_tot * mean)
        if ctx.need_minmax:
            gmax, gmin = grads[:2]
            for arg, g in ((amax, gmax), (amin, gmin)):
                idx = arg.long()[:, :, None].expand(bsz, w.shape[1], cin)
                grad_x.scatter_add_(1, idx, g[:, :, None] * wt)
                grad_w = grad_w + torch.sum(
                    torch.gather(x, 1, idx) * g[:, :, None], dim=0).t()
                grad_b = grad_b + torch.sum(g, dim=0)
        else:
            gsum = grads[0]
            grad_x = grad_x + (gsum @ wt)[:, None, :]
            grad_w = grad_w + torch.sum(x, dim=1).t() @ gsum
            grad_b = grad_b + n * torch.sum(gsum, dim=0)
        return grad_x, grad_w, grad_b, None


def _pooled_tail(x, conv: PLinear, bn: BN, sym_op: str, act_relu: bool):
    """Train-mode conv3 -> bn3 -> (relu) -> pool over points. BN with batch
    statistics is a per-channel affine, and relu and the pools commute with
    it: the max pool takes max_n c where the scale is >= 0 and min_n c
    elsewhere, the sum pool scales sum_n c."""
    need_minmax = sym_op == "max"
    out = _LinearPoolReductions.apply(
        x.contiguous(), conv.kernel().contiguous(), conv.bias, need_minmax)
    mean, var = out[-2:]
    bn.update_running_stats(mean.detach(), var.detach())
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * inv
    if need_minmax:
        pooled = torch.where(inv >= 0, out[0], out[1]) * inv + shift
    else:
        pooled = out[0] * inv + x.shape[1] * shift
    return torch.relu(pooled) if act_relu else pooled


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
        # the transformers pool with max whatever the encoder's sym_op, then
        # relu (it commutes with the max)
        if self.training:
            h = _conv_bn_relu(x, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            h = _pooled_tail(h, self.conv3, self.bn3, "max", act_relu=True)
        else:
            layers = (_chain_layer(self.conv1, self.bn1),
                      _chain_layer(self.conv2, self.bn2),
                      _chain_layer(self.conv3, self.bn3))
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
        # no relu after bn3 in the single-scale encoder (model.py:209-230)
        if self.training:
            h = _conv_bn_relu(h, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            h = _pooled_tail(h, self.conv3, self.bn3, self.sym_op,
                             act_relu=False)
        else:
            layers = (_chain_layer(self.conv1, self.bn1),
                      _chain_layer(self.conv2, self.bn2),
                      _chain_layer(self.conv3, self.bn3))
            h = chain_pool(h.contiguous(), layers, sym_op=self.sym_op)
        return h, trans, trans_quat, trans2
