"""Plain PyTorch reference of the Points2Surf dual-branch SDF regressor, in
float32 with every product an explicit matmul of float32 operands.

Written from the upstream description (github.com/ErlerPhilipp/points2surf,
``source/points_to_surf_model.py``) and the port's documented semantics,
with no kernel, no folded BatchNorm and no covariance form: each layer is
computed as written. Parameter and buffer names are the upstream
``state_dict``'s, so one dictionary of seeded weights loads into both this
model and the program.

``tf32=True`` rounds every matmul operand to TF32 (10 mantissa bits, round
to nearest even) and accumulates in float32: what a float32 matmul with
TF32 on computes, on any device. That is the control of the benchmark's
comparison, the nearest precision below the configuration's.

Training mode is flax's BatchNorm: statistics over the batch and point
axes, the biased variance. Running statistics are not updated: a
reference step is compared by its loss and gradients only.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5
C1, C2 = 64, 128


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    """``a @ b`` with every operand of the forward's and the backward's
    products rounded to TF32, float32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape)
        gb = torch.matmul(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b`` (batched, broadcast); with ``tf32`` as TF32 computes it."""
    if tf32:
        return _MatmulTF32.apply(a, b)
    return torch.matmul(a, b)


class Lin(nn.Module):
    """Pointwise (conv, weight (out, in, 1)) or fc (weight (out, in))."""

    def __init__(self, cin: int, cout: int, conv: bool):
        super().__init__()
        shape = (cout, cin, 1) if conv else (cout, cin)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, tf32):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return mm(x, w.t(), tf32) + self.bias


class Norm(nn.Module):
    """BatchNorm on channels-last input (eps 1e-5)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=dims)
            var = torch.mean((x - mean) ** 2, dim=dims)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + EPS) * self.weight + self.bias


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions [w, x, y, z], normalized by s = 2 / |q|^2 ->
    (..., 3, 3) rotations (upstream ``source/base/utils.py``)."""
    s = 2.0 / torch.sum(q * q, dim=-1)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - (y * y + z * z) * s, (x * y - z * w) * s,
                     (x * z + y * w) * s], -1),
        torch.stack([(x * y + z * w) * s, 1 - (x * x + z * z) * s,
                     (y * z - x * w) * s], -1),
        torch.stack([(x * z - y * w) * s, (y * z + x * w) * s,
                     1 - (x * x + y * y) * s], -1),
    ], -2)


def rotate(pts: torch.Tensor, rot: torch.Tensor, tf32: bool):
    """(B, n, 3) points by (B, 3, 3) rotations: p @ R^T."""
    return mm(pts, rot.transpose(-1, -2), tf32)


class Trunk(nn.Module):
    """A transformer: conv cin -> 64 -> 128 -> net, max pool, relu, fc net ->
    net/2 -> net/4 -> out."""

    def __init__(self, cin: int, net: int, out: int):
        super().__init__()
        self.conv1 = Lin(cin, C1, True)
        self.conv2 = Lin(C1, C2, True)
        self.conv3 = Lin(C2, net, True)
        self.fc1 = Lin(net, net // 2, False)
        self.fc2 = Lin(net // 2, net // 4, False)
        self.fc3 = Lin(net // 4, out, False)
        self.bn1, self.bn2, self.bn3 = Norm(C1), Norm(C2), Norm(net)
        self.bn4, self.bn5 = Norm(net // 2), Norm(net // 4)

    def forward(self, x, tf32):
        h = torch.relu(self.bn1(self.conv1(x, tf32)))
        h = torch.relu(self.bn2(self.conv2(h, tf32)))
        h = torch.relu(torch.amax(self.bn3(self.conv3(h, tf32)), dim=1))
        h = torch.relu(self.bn4(self.fc1(h, tf32)))
        h = torch.relu(self.bn5(self.fc2(h, tf32)))
        return self.fc3(h, tf32)


class QSTN(Trunk):
    def __init__(self, net: int):
        super().__init__(3, net, 4)

    def forward(self, x, tf32):
        q = super().forward(x, tf32) + x.new_tensor([1.0, 0.0, 0.0, 0.0])
        return quat_to_rotmat(q)


class STN(Trunk):
    def __init__(self, net: int):
        super().__init__(C1, net, C1 * C1)

    def forward(self, x, tf32):
        h = super().forward(x, tf32)
        eye = torch.eye(C1, dtype=h.dtype, device=h.device).reshape(-1)
        return (h + eye).reshape(x.shape[0], C1, C1)


class Encoder(nn.Module):
    """(optional point STN) -> conv 3 -> 64 -> 64 -> (feature STN) -> conv
    64 -> 64 -> 128 -> net -> max pool (no relu after the last BN)."""

    def __init__(self, net: int, point_stn: bool, feat_stn: bool):
        super().__init__()
        self.stn1 = QSTN(net) if point_stn else None
        self.conv0a = Lin(3, C1, True)
        self.conv0b = Lin(C1, C1, True)
        self.bn0a, self.bn0b = Norm(C1), Norm(C1)
        self.stn2 = STN(net) if feat_stn else None
        self.conv1 = Lin(C1, C1, True)
        self.conv2 = Lin(C1, C2, True)
        self.conv3 = Lin(C2, net, True)
        self.bn1, self.bn2, self.bn3 = Norm(C1), Norm(C2), Norm(net)

    def forward(self, x, tf32):
        trans = None
        if self.stn1 is not None:
            trans = self.stn1(x, tf32)
            x = rotate(x, trans, tf32)
        h = torch.relu(self.bn0a(self.conv0a(x, tf32)))
        h = torch.relu(self.bn0b(self.conv0b(h, tf32)))
        if self.stn2 is not None:
            h = mm(h, self.stn2(h, tf32).transpose(1, 2), tf32)
        h = torch.relu(self.bn1(self.conv1(h, tf32)))
        h = torch.relu(self.bn2(self.conv2(h, tf32)))
        return torch.amax(self.bn3(self.conv3(h, tf32)), dim=1), trans


class P2S(nn.Module):
    """The configuration's model (``configs/*.json``'s ``model``); the
    single-encoder variant is not covered."""

    def __init__(self, m: dict):
        super().__init__()
        if m["single_transformer"] or m["sym_op"] != "max":
            raise ValueError("the reference covers two encoders, max pool")
        net = m["net_size"]
        self.shared = m["use_point_stn"] and m["shared_transformation"]
        if self.shared:
            self.point_stn = QSTN(net)
        self.feat_global = Encoder(net, m["use_point_stn"] and not self.shared,
                                   m["use_feat_stn"])
        self.fc1_global = Lin(net, net // 2, False)
        self.bn1_global = Norm(net // 2)
        self.feat_local = Encoder(net, False, m["use_feat_stn"])
        self.fc1_local = Lin(net, net // 2, False)
        self.bn1_local = Norm(net // 2)
        self.fc2 = Lin(net, net // 4, False)
        self.bn2 = Norm(net // 4)
        self.fc3 = Lin(net // 4, net // 8, False)
        self.bn3 = Norm(net // 8)
        self.fc4 = Lin(net // 8, m["output_dim"], False)

    def forward(self, patch, sub, query, tf32=False):
        """patch (B, P, 3) in patch space, sub (B, S, 3) and query (B, 3) in
        model space -> (B, output_dim) raw predictions."""
        sub = sub - query[:, None, :]
        if self.shared:
            trans = self.point_stn(torch.cat([patch, sub], 1), tf32)
            sub, patch = rotate(sub, trans, tf32), rotate(patch, trans, tf32)
        g, trans_g = self.feat_global(sub, tf32)
        g = torch.relu(self.bn1_global(self.fc1_global(g, tf32)))
        if trans_g is not None:
            patch = rotate(patch, trans_g, tf32)
        loc = self.feat_local(patch, tf32)[0]
        loc = torch.relu(self.bn1_local(self.fc1_local(loc, tf32)))
        h = torch.cat([loc, g], 1)
        h = torch.relu(self.bn2(self.fc2(h, tf32)))
        h = torch.relu(self.bn3(self.fc3(h, tf32)))
        return self.fc4(h, tf32)


def seeded_weights(model: nn.Module, generator: torch.Generator) -> dict:
    """The benchmark's weights for ``model``'s names and shapes, made on the
    generator's device in two calls (one uniform, one normal draw over every
    element), by each name's role:

    * ``conv*`` / ``fc*`` weight and bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
      (torch's default), a transformer's last fc layer (``*stn*.fc3``) at
      1/100 of it, so that the transforms start near the identity;
    * BatchNorm (``bn*``): weight U(0.5, 1.5), bias N(0, 0.01), running mean
      N(0, 0.01), running variance U(0.5, 1.5), ``num_batches_tracked`` 0.
    """
    dev = generator.device
    state = model.state_dict()
    names = sorted(k for k, v in state.items() if v.is_floating_point())
    total = sum(state[k].numel() for k in names)
    uni = torch.rand(total, generator=generator, device=dev)
    nrm = torch.randn(total, generator=generator, device=dev)
    out, start = {}, 0
    for k in names:
        shape = state[k].shape
        n = state[k].numel()
        u = uni[start:start + n].reshape(shape)
        z = nrm[start:start + n].reshape(shape)
        start += n
        module, leaf = k.rsplit(".", 1)
        last = module.rsplit(".", 1)[-1]
        if last.startswith("bn"):
            out[k] = {"weight": u + 0.5, "bias": 0.1 * z,
                      "running_mean": 0.1 * z, "running_var": u + 0.5}[leaf]
        else:
            w = state[module + ".weight"]
            bound = w[0].numel() ** -0.5
            if "stn" in module and last == "fc3":
                bound *= 0.01
            out[k] = (2.0 * u - 1.0) * bound
    for k, v in state.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=dev)
    return out
