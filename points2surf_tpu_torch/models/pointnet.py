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
and updates the running variance, ``r = 0.9 r + 0.1 batch``.

**Data parallelism** (``parallel/``): every batch statistic is taken over
the global batch, as under the JAX package's data mesh. Each layer forms
its statistics on this rank's rows and :func:`_global_means` sums them over
the ranks with a gradient (``parallel.distributed.global_sum``): the BN
layers' mean and mean square, the covariance form's mean and Gram, and the
pooled tails' mean and mean square from the kernel's local sums, so the
kernels run on each rank's rows (the JAX package's ``_sharded`` kernel
wrappers). The running statistics update with the global values and stay
equal on every rank. In a world of one nothing changes and no collective
is launched.

**Tensor parallelism** (``parallel/sharding.py``, a grid with a ``model``
axis): a ``PLinear`` or ``BN`` that ``partition_params`` sharded holds its
model rank's column block (``layer.sharded``) and computes only
its columns: the covariance-form layers, the pooled tails and the eval
chains on the slice (the ``pooled_tail`` and ``chain_pool`` kernels run
unchanged on the block's W3 columns, a3 / c3 in eval and the bias in
training: their pools and statistics are per column), the FC layers with
their BatchNorms. :func:`_column_parallel` puts
``parallel.distributed.sum_input_grad`` on the layer's replicated input and
``gather_columns`` on its output, so every layer after it sees the full
width and every replicated layer the whole gradient. An eval chain whose
first two layers are sharded too (a net narrow enough for ``min_dim``)
gathers their folded weights, as layers 1-2 run whole in the kernel.

**Activation dtype** (``dtype=torch.bfloat16``, the JAX package's
``--train_dtype`` / ``--eval_dtype bfloat16``; independent of the operand
modes above, which keep fp32 activations). As flax computes with
``dtype=bfloat16`` and fp32 parameters: every linear layer rounds its input,
weights and bias to bf16 and returns bf16; BatchNorm takes its statistics
and normalizes in fp32 and returns bf16 (running statistics stay fp32). The
JAX package's gates send bf16 to its literal stack, and so does this port:
no covariance form, no ``chain_pool`` (the eval conv3 tail is the bf16
matmul, the fp32 affine and the pool, in row chunks), and the train tail is
``_LinearPoolReductions``' plain bf16 branch (``pooled_tail`` is fp32 only
there). No kernel is launched in bf16.

**Multi-scale** (``num_scales > 1``, the reference's dormant branch): the
point axis holds ``num_scales`` equal segments, pooled one by one
(``_scale_pool``); the trunks add ``fc0``/``bn0`` before their head and the
encoder a ``conv4``/``bn4`` expansion to ``output_size * num_scales``
channels, so its codeword has ``output_size * num_scales**2``. It runs the
literal stack, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from points2surf_tpu_torch.ops import geometry
from points2surf_tpu_torch.ops.kernels.chain_pool import chain_pool, fold_conv_bn
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_grad, pooled_tail_reductions)
from points2surf_tpu_torch.parallel.distributed import (
    data_size, gather_columns, global_sum, sum_input_grad)

BN_MOMENTUM = 0.9  # flax convention: weight of the old running statistic
# elements of the (rows, n, C) fp32 temporaries of one bf16 eval-tail chunk
_EVAL_TAIL_CHUNK = 1 << 27


class PLinear(nn.Module):
    """Pointwise linear layer on channels-last input.

    ``conv=True`` holds a torch ``Conv1d(k=1)`` weight (out, in, 1),
    otherwise a ``Linear`` weight (out, in); both with torch's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init. With ``act_dtype`` (flax's
    ``Dense(dtype=...)``; :func:`set_act_dtype`) input, weight and bias are
    cast to it."""

    act_dtype: torch.dtype | None = None
    # True where the layer holds its model rank's column block of the
    # installed grid (parallel/sharding.partition_params)
    sharded = False

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
        d = self.act_dtype
        if d is None:
            return torch.matmul(x, self.kernel()) + self.bias
        return torch.matmul(x.to(d), self.kernel().to(d)) + self.bias.to(d)


class BN(nn.BatchNorm1d):
    """BatchNorm with the parameters and running statistics of torch
    ``BatchNorm1d`` (eps 1e-5), on channels-last input. Train mode is
    flax's ``nn.BatchNorm``: statistics over every axis but the last, the
    biased variance E[x^2] - E[x]^2 (clipped at 0), running statistics
    ``0.9 r + 0.1 batch`` (stock ``BatchNorm1d`` would update the running
    variance with the unbiased one). With ``act_dtype`` (flax's
    ``BatchNorm(dtype=...)``) the statistics and the normalization stay
    fp32 and the output is cast to it. A sharded BN (``sharded``, as
    ``PLinear``) holds its column block of every leaf."""

    act_dtype: torch.dtype | None = None
    sharded = False

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
        d = self.act_dtype
        if d is None and not self.training:
            a, c = self.eval_affine()
            return x * a + c
        if d is not None:
            x = x.to(self.weight.dtype)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean, sq = _global_means(
                (torch.mean(x, dim=dims), torch.mean(x * x, dim=dims)),
                x.numel() // x.shape[-1])
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.update_running_stats(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * inv + self.bias
        return y if d is None else y.to(d)


def set_act_dtype(model: nn.Module, dtype: torch.dtype | None) -> None:
    """Switch every layer of ``model`` to activation dtype ``dtype`` (None:
    float32). Parameters keep their dtype, so an optimizer's state stays
    valid (the trainer's precision annealing)."""
    for mod in model.modules():
        if hasattr(mod, "act_dtype"):
            mod.act_dtype = dtype


def _global_means(means, count: int):
    """Per-channel means over this rank's ``count`` rows -> the means over
    every data rank's rows, in one collective that carries the gradient (the
    counts are summed with them). One data rank returns ``means``
    unchanged."""
    if data_size() == 1:
        return tuple(means)
    n = float(count)
    flat = global_sum(torch.cat([m.reshape(-1) * n for m in means]
                                + [means[0].new_tensor([n])]))
    n_tot = flat[-1].detach()
    out, start = [], 0
    for m in means:
        out.append((flat[start:start + m.numel()] / n_tot).reshape(m.shape))
        start += m.numel()
    return tuple(out)


def _column_parallel(fn, x, layer: PLinear):
    """``fn(x)``, where ``fn`` computes the output columns of ``layer`` (and
    of its BatchNorm and activation): whole for a whole layer; for a
    sharded one its column block, gathered over the model ranks, with the
    cotangent of the replicated input ``x`` summed over them."""
    if not layer.sharded:
        return fn(x)
    return gather_columns(fn(sum_input_grad(x)))


def _chain_layer(conv: PLinear, bn: BN):
    """Folded (W, a, c) triple of one conv + eval-BN layer (its column
    block for a sharded layer)."""
    a, c = fold_conv_bn(conv.bias, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)
    return conv.kernel().contiguous(), a, c


def _chain_layer_full(conv: PLinear, bn: BN):
    """:func:`_chain_layer` of the whole layer: a sharded layer's blocks
    gathered over the model ranks (layers 1-2 run whole in the kernel)."""
    layer = _chain_layer(conv, bn)
    if not conv.sharded:
        return layer
    return tuple(gather_columns(t).contiguous() for t in layer)


def _eval_chain(x, convs, bns, sym_op: str, act_relu: bool):
    """Eval chain conv1 -> bn1 -> relu -> conv2 -> bn2 -> relu -> conv3 ->
    bn3 -> (relu) -> pool as one ``chain_pool`` call on folded triples; for
    a sharded conv3 on its column block (the kernel on the slice) and
    gathered."""
    head = (_chain_layer_full(convs[0], bns[0]),
            _chain_layer_full(convs[1], bns[1]))

    def block(h):
        out = chain_pool(h.contiguous(),
                         head + (_chain_layer(convs[2], bns[2]),),
                         sym_op=sym_op)
        return torch.relu(out) if act_relu else out

    return _column_parallel(block, x, convs[2])


def _dense(x, fc: PLinear, bn: BN | None = None, act_relu: bool = False):
    """fc -> (bn) -> (relu) on channels-last features, column-parallel when
    ``fc`` is sharded (its BatchNorm then is too)."""
    def block(h):
        h = fc(h)
        if bn is not None:
            h = bn(h)
        return torch.relu(h) if act_relu else h

    return _column_parallel(block, x, fc)


def _conv_bn_relu(x, conv: PLinear, bn: BN):
    """:func:`_conv_bn_relu_block`, column-parallel when ``conv`` is
    sharded."""
    return _column_parallel(lambda h: _conv_bn_relu_block(h, conv, bn), x,
                            conv)


def _conv_bn_relu_block(x, conv: PLinear, bn: BN):
    """Pointwise linear -> BatchNorm -> ReLU on (B, n, Cin). In fp32 train
    mode the covariance form of the JAX package (``_conv_bn_relu``): the
    batch statistics of ``y = x @ W + b`` are ``mean(x) @ W + b`` and
    ``diag(W^T Cov(x) W)``, and the layer is one matmul with the effective
    weights ``W * g / sigma``; autograd differentiates through it. Eval and
    bf16 activations take the literal layers, as the JAX package does."""
    if not bn.training or bn.act_dtype is not None:
        return torch.relu(bn(conv(x)))
    k, b = conv.kernel(), conv.bias
    n_tot = x.shape[0] * x.shape[1]
    xf = x.reshape(n_tot, x.shape[2])
    xm, gram = _global_means(
        (torch.sum(xf, dim=0) / n_tot, (xf.t() @ xf) / n_tot), n_tot)
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

    The forward is the ``pooled_tail`` kernel; with ``dtype`` (bf16
    activations, where the JAX package's gate turns its kernel off) it is
    ``_lpr_compute``: c in that dtype, max and min (first-index args) of it,
    the sums in fp32. The backward is ``_lpr_bwd``, in fp32 with the
    gradient of x cast to x's dtype: with N = B n, alpha = (g_mean - 2 mean
    g_var) / N and kappa = 2 g_var / N, dL/dc = (arg-row one-hots of g_max,
    g_min, or g_sum broadcast) + alpha + kappa c, pushed through the linear
    map analytically. The one-hot terms are ``pooled_tail_grad``: on a GPU
    a kernel that sorts each row's (point, channel) entries by point and
    adds g W^T to the arg rows of dx and g x[arg] to the columns of dW,
    with no (B, C, Cin) tensor; on the CPU its plain version, a
    scatter-add and a gather through a (B, C, Cin)-expanded index. Never
    (B, n, C).

    The statistics are this rank's: :func:`_pooled_tail` combines them over
    the ranks outside the Function, and autograd carries each rank's share
    of their cotangents back into it (the sharded wrapper's "kernel on the
    local rows, statistics reduced after")."""

    @staticmethod
    def forward(ctx, x, w, b, need_minmax: bool, dtype=None):
        n_tot = x.shape[0] * x.shape[1]
        if dtype is None:
            cmax, amax, cmin, amin, rsum, rsq = pooled_tail_reductions(x, w, b)
            mean = torch.sum(rsum, dim=0) / n_tot
            var = torch.sum(rsq, dim=0) / n_tot - mean * mean
        else:
            c = torch.matmul(x.to(dtype), w.to(dtype)) + b.to(dtype)
            cmax = cmin = amax = amin = None
            if need_minmax:
                cmax, amax = torch.amax(c, dim=1), torch.argmax(c, dim=1)
                cmin, amin = torch.amin(c, dim=1), torch.argmin(c, dim=1)
            c32 = c.to(w.dtype)
            rsum = torch.sum(c32, dim=1)
            mean = torch.sum(c32, dim=(0, 1)) / n_tot
            var = torch.sum(c32 * c32, dim=(0, 1)) / n_tot - mean * mean
        ctx.save_for_backward(x, w, b, amax, amin, mean)
        ctx.need_minmax = need_minmax
        if need_minmax:
            return cmax, cmin, mean, var
        return rsum, mean, var

    @staticmethod
    def backward(ctx, *grads):
        x, w, b, amax, amin, mean = ctx.saved_tensors
        x_dtype = x.dtype
        x = x.to(w.dtype)
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
            gmax, gmin = (g.to(w.dtype) for g in grads[:2])
            grad_w = pooled_tail_grad(x, w, amax, amin, gmax, gmin, grad_x,
                                      grad_w)
            grad_b = (grad_b + torch.sum(gmax, dim=0)
                      + torch.sum(gmin, dim=0))
        else:
            gsum = grads[0]
            grad_x = grad_x + (gsum @ wt)[:, None, :]
            grad_w = grad_w + torch.sum(x, dim=1).t() @ gsum
            grad_b = grad_b + n * torch.sum(gsum, dim=0)
        return grad_x.to(x_dtype), grad_w, grad_b, None, None


def _pooled_tail(x, conv: PLinear, bn: BN, sym_op: str, act_relu: bool):
    """:func:`_pooled_tail_block`, on the column slice when ``conv`` is
    sharded (the kernel runs on the block's columns)."""
    return _column_parallel(
        lambda h: _pooled_tail_block(h, conv, bn, sym_op, act_relu), x, conv)


def _pooled_tail_block(x, conv: PLinear, bn: BN, sym_op: str,
                       act_relu: bool):
    """Train-mode conv3 -> bn3 -> (relu) -> pool over points. BN with batch
    statistics is a per-channel affine, and relu and the pools commute with
    it: the max pool takes max_n c where the scale is >= 0 and min_n c
    elsewhere, the sum pool scales sum_n c."""
    need_minmax = sym_op == "max"
    d = conv.act_dtype
    out = _LinearPoolReductions.apply(
        x.contiguous(), conv.kernel().contiguous(), conv.bias, need_minmax, d)
    mean, var = out[-2:]
    if data_size() > 1:  # the global moments from this rank's
        mean, sq = _global_means((mean, var + mean * mean),
                                 x.shape[0] * x.shape[1])
        var = sq - mean * mean
    bn.update_running_stats(mean.detach(), var.detach())
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * inv
    if need_minmax:
        pooled = (torch.where(inv >= 0, out[0].to(inv.dtype),
                              out[1].to(inv.dtype)) * inv + shift)
    else:
        pooled = out[0] * inv + x.shape[1] * shift
    pooled = torch.relu(pooled) if act_relu else pooled
    return pooled if d is None else pooled.to(d)


def _eval_tail(x, conv: PLinear, bn: BN, sym_op: str, act_relu: bool):
    """:func:`_eval_tail_block`, on the column slice when ``conv`` is
    sharded."""
    return _column_parallel(
        lambda h: _eval_tail_block(h, conv, bn, sym_op, act_relu), x, conv)


def _eval_tail_block(x, conv: PLinear, bn: BN, sym_op: str,
                     act_relu: bool):
    """Eval conv3 -> bn3 -> (relu) -> pool of the literal stack (the JAX
    package's eval ``_pooled_tail``, which bf16 activations take): c = x @ W
    + b in the activation dtype, the running-statistics affine in fp32, the
    pool, cast back. For the max pool the affine and relu go after it, on
    max_n c (min_n c where the scale is negative): fp32 rounding is
    monotone, so that is the same number, and no (B, n, C) fp32 tensor is
    formed. Rows go in chunks that bound the (rows, n, C) temporaries."""
    d = conv.act_dtype or x.dtype
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * inv
    k, bias = conv.kernel().to(d), conv.bias.to(d)
    rows = max(1, _EVAL_TAIL_CHUNK // max(1, x.shape[1] * k.shape[1]))
    out = []
    for s in range(0, x.shape[0], rows):
        c = torch.matmul(x[s:s + rows].to(d), k) + bias
        if sym_op == "max":
            cmin, cmax = torch.aminmax(c, dim=1)
            y = torch.where(inv >= 0, cmax.to(inv.dtype), cmin.to(inv.dtype))
            y = y * inv + shift
            out.append(torch.relu(y) if act_relu else y)
        else:
            y = c.to(inv.dtype) * inv + shift
            out.append(torch.sum(torch.relu(y) if act_relu else y, dim=1))
    return torch.cat(out).to(d)


def _scale_pool(h: torch.Tensor, num_scales: int, sym_op: str = "max"):
    """Pool each of the ``num_scales`` equal segments of the point axis and
    concatenate them scale-major along the channels (reference
    model.py:48-56, 219-230): (B, n, C) -> (B, num_scales * C)."""
    b, n, c = h.shape
    h = h.reshape(b, num_scales, n // num_scales, c)
    h = torch.amax(h, dim=2) if sym_op == "max" else torch.sum(h, dim=2)
    return h.reshape(b, num_scales * c)


class _STNTrunk(nn.Module):
    """Conv trunk + FC head shared by STN and QSTN (reference
    model.py:41-64, 100-122)."""

    def __init__(self, in_features: int, net_size_max: int,
                 out_features: int, num_scales: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_scales = num_scales
        self.act_dtype = dtype
        self.conv1 = PLinear(in_features, 64, conv=True)
        self.conv2 = PLinear(64, 128, conv=True)
        self.conv3 = PLinear(128, net_size_max, conv=True)
        if num_scales > 1:
            self.fc0 = PLinear(net_size_max * num_scales, net_size_max,
                               conv=False)
            self.bn0 = BN(net_size_max)
        self.fc1 = PLinear(net_size_max, net_size_max // 2, conv=False)
        self.fc2 = PLinear(net_size_max // 2, net_size_max // 4, conv=False)
        self.fc3 = PLinear(net_size_max // 4, out_features, conv=False)
        self.bn1 = BN(64)
        self.bn2 = BN(128)
        self.bn3 = BN(net_size_max)
        self.bn4 = BN(net_size_max // 2)
        self.bn5 = BN(net_size_max // 4)
        set_act_dtype(self, dtype)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        # the transformers pool with max whatever the encoder's sym_op, then
        # relu (it commutes with the max)
        literal = self.num_scales > 1 or self.act_dtype is not None
        if not literal and self.training:
            h = _conv_bn_relu(x, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            h = _pooled_tail(h, self.conv3, self.bn3, "max", act_relu=True)
        elif not literal:
            h = _eval_chain(x, (self.conv1, self.conv2, self.conv3),
                            (self.bn1, self.bn2, self.bn3), "max",
                            act_relu=True)
        else:
            h = _conv_bn_relu(x, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            if self.num_scales > 1:
                h = _dense(h, self.conv3, self.bn3, act_relu=True)
                h = _scale_pool(h, self.num_scales)
            elif self.training:
                h = _pooled_tail(h, self.conv3, self.bn3, "max",
                                 act_relu=True)
            else:
                h = _eval_tail(h, self.conv3, self.bn3, "max", act_relu=True)
        if self.num_scales > 1:
            h = _dense(h, self.fc0, self.bn0, act_relu=True)
        h = _dense(h, self.fc1, self.bn4, act_relu=True)
        h = _dense(h, self.fc2, self.bn5, act_relu=True)
        return _dense(h, self.fc3)


class STN(_STNTrunk):
    """Feature transformer: (B, n, dim) -> (B, dim, dim) matrix + identity."""

    def __init__(self, net_size_max: int = 1024, dim: int = 64,
                 num_scales: int = 1, dtype: torch.dtype | None = None):
        super().__init__(dim, net_size_max, dim * dim, num_scales, dtype)
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x)
        iden = torch.eye(self.dim, dtype=h.dtype, device=h.device).reshape(-1)
        return (h + iden).reshape(x.shape[0], self.dim, self.dim)


class QSTN(_STNTrunk):
    """Quaternion point transformer: (B, n, 3) -> rotation (B, 3, 3) and the
    quaternion (B, 4); a zero network output is the identity."""

    def __init__(self, net_size_max: int = 1024, num_scales: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__(3, net_size_max, 4, num_scales, dtype)

    def forward(self, x: torch.Tensor):
        h = self.trunk(x)
        # the identity quaternion (1, 0, 0, 0), made on the device
        quat = h + torch.eye(1, 4, dtype=h.dtype, device=h.device)
        return geometry.quat_to_rotmat(quat), quat


class PointNetFeat(nn.Module):
    """Shared-MLP point encoder (reference model.py:134-234): optional QSTN
    rotation -> MLP(64, 64) -> optional 64-d feature STN -> MLP(64, 128,
    output_size) -> max or sum pool. (B, n, 3) -> (B, output_size), or with
    ``num_scales`` segments of the point axis (B, output_size *
    num_scales**2)."""

    def __init__(self, net_size_max: int = 1024, output_size: int = 1024,
                 use_point_stn: bool = True, use_feat_stn: bool = True,
                 sym_op: str = "max", num_scales: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if sym_op not in ("max", "sum"):
            raise ValueError(f"Unsupported symmetric operation: {sym_op}")
        self.sym_op = sym_op
        self.num_scales = num_scales
        self.act_dtype = dtype
        self.stn1 = (QSTN(net_size_max, num_scales, dtype) if use_point_stn
                     else None)
        self.conv0a = PLinear(3, 64, conv=True)
        self.conv0b = PLinear(64, 64, conv=True)
        self.bn0a = BN(64)
        self.bn0b = BN(64)
        self.stn2 = (STN(net_size_max, 64, num_scales, dtype)
                     if use_feat_stn else None)
        self.conv1 = PLinear(64, 64, conv=True)
        self.conv2 = PLinear(64, 128, conv=True)
        self.conv3 = PLinear(128, output_size, conv=True)
        self.bn1 = BN(64)
        self.bn2 = BN(128)
        self.bn3 = BN(output_size)
        if num_scales > 1:
            self.conv4 = PLinear(output_size, output_size * num_scales,
                                 conv=True)
            self.bn4 = BN(output_size * num_scales)
        set_act_dtype(self, dtype)

    def forward(self, x: torch.Tensor):
        trans = trans_quat = trans2 = None
        if self.stn1 is not None:
            trans, trans_quat = self.stn1(x)
            x = geometry.transform_points(x, trans)
        h = _conv_bn_relu(x, self.conv0a, self.bn0a)
        h = _conv_bn_relu(h, self.conv0b, self.bn0b)
        if self.stn2 is not None:
            trans2 = self.stn2(h)
            # einsum("bij,bnj->bni"), in the activation dtype
            h = torch.bmm(h, trans2.transpose(1, 2))
        # no relu after bn3 in the single-scale encoder (model.py:209-230)
        literal = self.num_scales > 1 or self.act_dtype is not None
        if not literal and self.training:
            h = _conv_bn_relu(h, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            h = _pooled_tail(h, self.conv3, self.bn3, self.sym_op,
                             act_relu=False)
        elif not literal:
            h = _eval_chain(h, (self.conv1, self.conv2, self.conv3),
                            (self.bn1, self.bn2, self.bn3), self.sym_op,
                            act_relu=False)
        else:
            h = _conv_bn_relu(h, self.conv1, self.bn1)
            h = _conv_bn_relu(h, self.conv2, self.bn2)
            if self.num_scales > 1:
                # the (output_size -> output_size * num_scales) expansion,
                # then each scale segment pooled (model.py:207-230)
                h = _dense(h, self.conv3, self.bn3)
                h = _dense(torch.relu(h), self.conv4, self.bn4)
                h = _scale_pool(h, self.num_scales, self.sym_op)
            elif self.training:
                h = _pooled_tail(h, self.conv3, self.bn3, self.sym_op,
                                 act_relu=False)
            else:
                h = _eval_tail(h, self.conv3, self.bn3, self.sym_op,
                               act_relu=False)
        return h, trans, trans_quat, trans2
