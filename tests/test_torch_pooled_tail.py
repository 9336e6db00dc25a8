"""Port parity: the train-tail reductions (``ops/kernels/pooled_tail.py``) and
the autograd function over them (``models/pointnet._LinearPoolReductions``).

On the CPU the wrapper takes its plain PyTorch version, held here against
the JAX Pallas kernel in interpret mode with fp32 operands
(``P2S_PALLAS_TAIL_PREC=highest``), at the JAX package's own shapes and
tolerances (tests/test_pallas.py): max/min atol 2e-4, sums rtol 2e-4 /
atol 2e-3, sums of squares rtol 2e-4 / atol 2e-2, and the arg contract (the
value at the arg index equals the pooled value; ties may pick another
index). The forward and hand-derived backward of the pooled reductions are
held against ``jax.value_and_grad`` of ``_linear_pool_reductions`` at
rtol 1e-4 (value) and rtol / atol 1e-3 (gradients). The CUDA kernel is held
against the plain version on the card (``cuda``-marked tests).

The backward's one-hot terms (``pooled_tail_grad``): on the CPU the plain
version must be the scatter-add and gather the backward always ran, bit for
bit, and the whole backward is held against the JAX package's ``_lpr_bwd``
on the same residuals, on column slices of W too. On the card the kernel is
held against the plain version at rtol 1e-5 of max|grad| (fp32 sums in
another order) and must rerun bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.pointnet import _LinearPoolReductions
from points2surf_tpu_torch.ops.kernels.pooled_tail import (
    pooled_tail_grad,
    pooled_tail_grad_reference,
    pooled_tail_reductions,
    pooled_tail_reductions_reference,
)


def _inputs(rng, b, n, cin, c):
    x = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(cin, c) * 0.1).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, w, bias


def _check_reductions(out, x, w, bias):
    """Outputs against the dense float64 oracle, at the JAX test's
    tolerances."""
    cmax, amax, cmin, amin, rsum, rsq = (np.asarray(o) for o in out)
    b, n, cin = x.shape
    c = w.shape[1]
    dense = (x.reshape(b * n, cin).astype(np.float64) @ w + bias).reshape(
        b, n, c)
    np.testing.assert_allclose(cmax, dense.max(1), atol=2e-4)
    np.testing.assert_allclose(cmin, dense.min(1), atol=2e-4)
    np.testing.assert_allclose(rsum, dense.sum(1), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(rsq, (dense * dense).sum(1), rtol=2e-4,
                               atol=2e-2)
    bb = np.arange(b)[:, None]
    cc = np.arange(c)[None, :]
    assert amax.dtype == np.int32 and amin.dtype == np.int32
    np.testing.assert_allclose(dense[bb, amax, cc], cmax, atol=2e-4)
    np.testing.assert_allclose(dense[bb, amin, cc], cmin, atol=2e-4)


@pytest.fixture
def tail_highest(monkeypatch):
    jax = pytest.importorskip("jax")
    monkeypatch.setenv("P2S_PALLAS_TAIL_PREC", "highest")
    jax.clear_caches()  # read at trace time
    yield
    monkeypatch.delenv("P2S_PALLAS_TAIL_PREC")
    jax.clear_caches()


@pytest.mark.parametrize("b,n,cin,c",
                         [(16, 300, 128, 256), (8, 130, 128, 128)])
def test_pooled_tail_matches_jax(rng, tail_highest, b, n, cin, c):
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.ops.pallas import train_tail

    x, w, bias = _inputs(rng, b, n, cin, c)
    got = pooled_tail_reductions(*(torch.from_numpy(a) for a in (x, w, bias)))
    _check_reductions([g.numpy() for g in got], x, w, bias)
    want = train_tail.pooled_tail_reductions(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True)
    _check_reductions(want, x, w, bias)
    for g, j in zip(got, want):
        if g.dtype == torch.int32:
            continue  # ties may differ; the value contract is checked above
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_linear_pool_reductions_grad_matches_jax(rng, sym_op):
    """Value and gradients of sum(pooled^2) + sum(mean) + sum(var), the
    objective of the JAX package's own glue test."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.models import pointnet as jpn

    x, w, bias = _inputs(rng, 8, 70, 128, 128)
    need_minmax = sym_op == "max"

    def jax_fn(xx, ww, bb):
        cmax, cmin, csum, mean, var = jpn._linear_pool_reductions(
            xx, ww, bb, None, need_minmax, True)
        pooled = cmax + cmin if need_minmax else csum
        return jnp.sum(pooled * pooled) + jnp.sum(mean) + jnp.sum(var)

    want, want_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))

    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    out = _LinearPoolReductions.apply(*args, need_minmax)
    pooled = out[0] + out[1] if need_minmax else out[0]
    got = (pooled * pooled).sum() + out[-2].sum() + out[-1].sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for a, g in zip(args, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-3)


def test_linear_pool_reductions_grad_matches_autograd(rng):
    """The hand-derived backward against autograd of the literal stack
    (the second oracle), with ties: duplicated rows, as padded patches
    have."""
    x, w, bias = _inputs(rng, 4, 40, 128, 64)
    x[:, 30:] = x[:, :1]  # ten copies of row 0 in every batch row
    gens = [torch.from_numpy(a) for a in (x, w, bias)]
    weights = torch.from_numpy(rng.randn(4, 64, 4).astype(np.float32))

    def objective(cmax, cmin, mean, var):
        return ((cmax * weights[..., 0]).sum() + (cmin * weights[..., 1]).sum()
                + (mean * weights[0, :, 2]).sum()
                + (var * weights[0, :, 3]).sum())

    args = [g.clone().requires_grad_() for g in gens]
    objective(*_LinearPoolReductions.apply(*args, True)).backward()
    ref = [g.clone().requires_grad_() for g in gens]
    c = ref[0] @ ref[1] + ref[2]
    mean = c.mean(dim=(0, 1))
    var = (c * c).mean(dim=(0, 1)) - mean * mean
    objective(c.amax(1), c.amin(1), mean, var).backward()

    def merge_ties(g):  # rows 30.. are copies of row 0
        return torch.cat([g[:, :1] + g[:, 30:].sum(1, keepdim=True),
                          g[:, 1:30]], dim=1)

    # amax spreads a tie's gradient over the tied rows, the arg form routes
    # it to one of them: compare x's gradient summed over the tied rows
    torch.testing.assert_close(merge_ties(args[0].grad),
                               merge_ties(ref[0].grad), rtol=1e-4, atol=1e-4)
    for a, r in zip(args[1:], ref[1:]):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-4, atol=1e-4)


def test_pooled_tail_wrapper_checks(rng):
    x, w, bias = (torch.from_numpy(a) for a in _inputs(rng, 2, 5, 128, 16))
    with pytest.raises(ValueError):
        pooled_tail_reductions(x.double(), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x.transpose(0, 1), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x[..., :64].contiguous(), w, bias)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x[:, :0], w, bias)
    # the plain version is what a CPU tensor takes; it launches nothing
    before = pooled_tail_reductions.launches
    out = pooled_tail_reductions(x, w, bias)
    assert pooled_tail_reductions.launches == before
    for o, r in zip(out, pooled_tail_reductions_reference(x, w, bias)):
        assert torch.equal(o, r)


def _grad_case(gen, b, n, c, kind="random", device="cpu"):
    """Inputs of pooled_tail_grad: post-relu x, W, args of the forward (so
    a row's args gather on its extreme points) or of ``kind``, cotangents
    and dense terms already in grad_x and grad_w. ``kind``: "random";
    "one_point" (every arg of a row on one point); "distinct" (no two args
    of a row on one point where n allows); "zero_min" (gmin all zero);
    "mixed" (the model's pattern: a channel's BN scale picks which of gmax
    and gmin is nonzero)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(device)

    x = torch.relu(randn(b, n, 128))
    w = randn(128, c) / 128 ** 0.5
    _, amax, _, amin, _, _ = pooled_tail_reductions(
        x, w, torch.zeros(c, device=device))
    gmax, gmin = randn(b, c), randn(b, c)
    if kind == "one_point":
        amax = amin = torch.full_like(amax, n // 2)
    elif kind == "distinct":
        ids = torch.arange(2 * c, device=device, dtype=torch.int32) % n
        amax, amin = (ids[None, :c].expand(b, c).contiguous(),
                      ids[None, c:].expand(b, c).contiguous())
    elif kind == "zero_min":
        gmin = torch.zeros_like(gmin)
    elif kind == "mixed":
        up = randn(c) >= 0
        gmax, gmin = (torch.where(up, gmax, 0.0), torch.where(up, 0.0, gmin))
    return (x, w, amax, amin, gmax, gmin, 0.01 * randn(b, n, 128),
            0.01 * randn(128, c))


@pytest.mark.parametrize("b,n,c,kind,dtype", [
    (4, 40, 64, "random", torch.float32), (3, 1, 7, "one_point", torch.float32),
    (5, 129, 100, "mixed", torch.float32), (4, 40, 64, "mixed", torch.float64)])
def test_pooled_tail_grad_plain_is_the_backward_scatter(b, n, c, kind, dtype):
    """The plain version is, bit for bit, what the backward's one-hot terms
    always were: per arg a scatter-add into grad_x and a gather sum added
    to grad_w, max then min; with int32 args (the kernel's) and int64 (bf16
    activations' argmax), and in float64 (the card-against-CPU checks'
    reference steps)."""
    x, w, amax, amin, gmax, gmin, grad_x, grad_w = (
        t.to(dtype) if t.is_floating_point() else t for t in _grad_case(
            torch.Generator().manual_seed(1), b, n, c, kind))
    want_x, want_w = grad_x.clone(), grad_w.clone()
    for arg, g in ((amax, gmax), (amin, gmin)):
        idx = arg.long()[:, :, None].expand(b, c, 128)
        want_x.scatter_add_(1, idx, g[:, :, None] * w.t())
        want_w = want_w + torch.sum(
            torch.gather(x, 1, idx) * g[:, :, None], dim=0).t()
    for dtype in (torch.int32, torch.int64):
        got_x = grad_x.clone()
        before = pooled_tail_grad.launches
        got_w = pooled_tail_grad(x, w, amax.to(dtype), amin.to(dtype), gmax,
                                 gmin, got_x, grad_w)
        assert pooled_tail_grad.launches == before
        assert torch.equal(got_x, want_x) and torch.equal(got_w, want_w)


def test_pooled_tail_grad_checks():
    x, w, amax, amin, gmax, gmin, grad_x, grad_w = _grad_case(
        torch.Generator().manual_seed(2), 2, 5, 16)
    args = [x, w, amax, amin, gmax, gmin, grad_x, grad_w]
    for i, bad in ((0, x[:1]), (1, w[:, :8]), (2, amax.float()),
                   (3, amin[:1]), (4, gmax[:, :3]), (5, gmin.t()),
                   (6, grad_x[:, :4]), (7, grad_w.t())):
        with pytest.raises(ValueError):
            pooled_tail_grad(*args[:i], bad, *args[i + 1:])


@pytest.mark.parametrize("c,zero", [(512, None), (256, None), (512, "min"),
                                    (256, "max")])
def test_linear_pool_reductions_grad_matches_jax_lpr_bwd(rng, c, zero):
    """The whole max-pool backward against the JAX package's ``_lpr_bwd`` on
    the same residuals (x, W, b, args, mean) and cotangents, at the widths
    of a W3 column slice (1024 columns over 2 and 4 model ranks), with one
    arg's cotangent all zero as the forward's where() makes it per
    channel."""
    jnp = pytest.importorskip("jax.numpy")
    from points2surf_tpu.models import pointnet as jpn

    x, w, bias = _inputs(rng, 6, 50, 128, c)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    out = _LinearPoolReductions.apply(*args, True)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in out]
    if zero is not None:
        cots[0 if zero == "max" else 1][:] = 0.0
    got = torch.autograd.grad(out, args, [torch.from_numpy(g) for g in cots])
    _, amax, _, amin, _, _ = pooled_tail_reductions(
        *(a.detach() for a in args))
    res = tuple(jnp.asarray(a) for a in (
        x, w, bias, amax.numpy(), amin.numpy(), out[2].detach().numpy()))
    want = jpn._lpr_bwd(None, True, True, res,
                        (jnp.asarray(cots[0]), jnp.asarray(cots[1]), None,
                         jnp.asarray(cots[2]), jnp.asarray(cots[3])))
    for name, g, j in zip(("x", "w", "b"), got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max(), err_msg=name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(device, b, n, c, kind="random"):
    # no conftest fixtures: this runs on the GPU host with --noconftest
    rng = np.random.RandomState(0)
    x, w, bias = _inputs(rng, b, n, 128, c)
    if kind == "negative":
        # every product x w < 0: TMA's zero rows past n would give c = b,
        # which wins the max, if they were not masked
        x, w = np.abs(x), -np.abs(w) - 1e-3
    x[:, n // 2:] = x[:, :1]  # duplicated rows: ties keep the first index
    return [torch.from_numpy(a).to(device) for a in (x, w, bias)]


# (b, n, C, kind): the train tails at batch 64 (n 1300, 1000, 300), ragged
# n (one past a slab, a single point, one short of a slab, exactly one
# slab), a ragged column tile (C 1000), all-negative products
CARD_CASES = [(64, 1300, 1024, "random"), (64, 1000, 1024, "random"),
              (64, 300, 1024, "random"), (37, 129, 1024, "random"),
              (5, 1, 1024, "random"), (3, 127, 1024, "random"),
              (2, 128, 1024, "random"), (37, 129, 1000, "random"),
              (64, 300, 1000, "negative"), (5, 1, 1024, "negative"),
              (3, 127, 1000, "negative")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,kind", CARD_CASES)
def test_pooled_tail_kernel_matches_plain(cuda_device, b, n, c, kind):
    t = _card_inputs(cuda_device, b, n, c, kind)
    before = pooled_tail_reductions.launches
    got = pooled_tail_reductions(*t)
    torch.cuda.synchronize()
    assert pooled_tail_reductions.launches == before + 1
    want = pooled_tail_reductions_reference(*t)
    for name, g, r in zip(("cmax", "amax", "cmin", "amin", "rsum", "rsq"),
                          got, want):
        if g.dtype == torch.int32:
            continue
        atol = 1e-4 * float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol, msg=name)
    c = t[0] @ t[1] + t[2]
    for v, a in ((got[0], got[1]), (got[2], got[3])):
        at = torch.gather(c, 1, a.long()[:, None, :])[:, 0]
        torch.testing.assert_close(at, v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))
    # rows n // 2 .. n - 1 copy row 0: a tie keeps the first index
    first = max(n // 2, 1)
    assert bool((got[1] < first).all()) and bool((got[3] < first).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1300), (3, 777), (64, 300)])
def test_pooled_tail_kernel_is_deterministic(cuda_device, b, n):
    # one block holds all of a row's points for its columns and reduces
    # them in a fixed order, the sums included
    t = _card_inputs(cuda_device, b, n, 1024, "negative")
    got = pooled_tail_reductions(*t)
    again = pooled_tail_reductions(*t)
    torch.cuda.synchronize()
    for name, g, a in zip(("cmax", "amax", "cmin", "amin", "rsum", "rsq"),
                          got, again):
        assert torch.equal(g, a), name


@pytest.mark.cuda
def test_pooled_tail_kernel_raises_on_other_cin(cuda_device):
    x = torch.zeros((2, 10, 64), device=cuda_device)
    w = torch.zeros((64, 32), device=cuda_device)
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device))


@pytest.mark.cuda
def test_pooled_tail_kernel_raises_on_misaligned_x(cuda_device):
    # a contiguous view 4 bytes into its storage: TMA needs 16-byte bases
    x = torch.zeros(2 * 10 * 128 + 1, device=cuda_device)[1:].view(2, 10, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    w = torch.zeros((128, 32), device=cuda_device)
    before = pooled_tail_reductions.launches
    with pytest.raises(ValueError):
        pooled_tail_reductions(x, w, torch.zeros(32, device=cuda_device))
    assert pooled_tail_reductions.launches == before


# (B, n, C): the max-pool train tails of p2s_max (batch 1001) and p2s_vanilla
# (701), W3 column slices at batch 64, a tiny ragged case and a C past one
# warp's ballot
GRAD_SHAPES = [(1001, 1000, 1024), (1001, 300, 1024), (701, 1300, 1024),
               (701, 1000, 1024), (701, 300, 1024), (64, 300, 512),
               (64, 300, 256), (64, 300, 128), (3, 1, 7), (5, 129, 1000)]


def _card_grad(device, b, n, c, kind):
    t = _grad_case(torch.Generator(device=device).manual_seed(b + n + c), b,
                   n, c, kind, device)
    want_x = t[6].clone()
    want_w = pooled_tail_grad_reference(*t[:6], want_x, t[7].clone())
    got_x = t[6].clone()
    before = pooled_tail_grad.launches
    got_w = pooled_tail_grad(*t[:6], got_x, t[7].clone())
    torch.cuda.synchronize()
    assert pooled_tail_grad.launches == before + 1
    return t, (got_x, got_w), (want_x, want_w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", GRAD_SHAPES)
@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_pooled_tail_grad_kernel_matches_plain(cuda_device, b, n, c, kind):
    _, got, want = _card_grad(cuda_device, b, n, c, kind)
    for name, g, r in zip(("grad_x", "grad_w"), got, want):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(64, 300, 1024), (5, 129, 1000),
                                   (3, 1, 7), (2, 4096, 2500)])
@pytest.mark.parametrize("kind", ["one_point", "distinct", "zero_min"])
def test_pooled_tail_grad_kernel_edge_args(cuda_device, b, n, c, kind):
    # every channel on one point (one warp sums 2C entries), no two args on
    # one point, one arg's cotangent all zero; C 2500 takes three passes of
    # 1,024 channels
    _, got, want = _card_grad(cuda_device, b, n, c, kind)
    for name, g, r in zip(("grad_x", "grad_w"), got, want):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(1001, 1000, 1024), (701, 1300, 1024),
                                   (64, 300, 256)])
def test_pooled_tail_grad_kernel_is_deterministic(cuda_device, b, n, c):
    t, got, _ = _card_grad(cuda_device, b, n, c, "mixed")
    again_x = t[6].clone()
    again_w = pooled_tail_grad(*t[:6], again_x, t[7].clone())
    torch.cuda.synchronize()
    assert torch.equal(got[0], again_x) and torch.equal(got[1], again_w)


@pytest.mark.cuda
def test_pooled_tail_grad_kernel_raises(cuda_device):
    t = list(_grad_case(torch.Generator(device=cuda_device).manual_seed(3),
                        2, 10, 32, device=cuda_device))
    before = pooled_tail_grad.launches
    narrow = [t[0][..., :64].contiguous(), t[1][:64].contiguous(), *t[2:6],
              t[6][..., :64].contiguous(), t[7][:64].contiguous()]
    with pytest.raises(ValueError):
        pooled_tail_grad(*narrow)
    with pytest.raises(ValueError):  # the kernel is float32 only
        pooled_tail_grad(*(a.double() if a.is_floating_point() else a
                           for a in t))
    # a contiguous view 4 bytes into its storage: the kernel loads float4s
    x = torch.zeros(2 * 10 * 128 + 1, device=cuda_device)[1:].view(2, 10, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    with pytest.raises(ValueError):
        pooled_tail_grad(x, *t[1:])
    assert pooled_tail_grad.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("point_stn,tails", [(True, 5), (False, 4)])
def test_pooled_tail_grad_launches_per_train_step(cuda_device, point_stn,
                                                  tails):
    """One launch per max-pooled train tail: 5 per step of the vanilla model
    (point STN, shared transformation), 4 of the max model."""
    from points2surf_tpu_torch.data.shapes import bucket_size
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.ops import patches as tp
    from points2surf_tpu_torch.train.trainer import make_train_step

    cloud = np.load(os.path.join(
        os.path.dirname(__file__), "..", "datasets", "abc_minimal", "04_pts",
        "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")).astype(
            np.float32)
    n = len(cloud)
    pts = np.zeros((bucket_size(n), 3), np.float32)
    pts[:n] = cloud
    pts = torch.from_numpy(pts).to(cuda_device)
    rng = np.random.RandomState(4)
    q = torch.from_numpy((cloud[rng.choice(n, 64)] + 0.01 * rng.randn(64, 3))
                         .astype(np.float32)).to(cuda_device)
    gt = torch.from_numpy(rng.uniform(-0.05, 0.05, 64).astype(
        np.float32)).to(cuda_device)
    torch.manual_seed(0)
    model = PointsToSurfModel(net_size_max=256, output_dim=2,
                              use_point_stn=point_stn,
                              shared_transformation=point_stn).to(cuda_device)
    cfg = tp.PatchConfig(points_per_patch=300, sub_sample_size=1000)
    step = make_train_step(model, ("imp_surf_magnitude", "imp_surf_sign"),
                           patch_cfg=cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for run in (1, 2):  # the first builds or loads the kernels
        before = pooled_tail_grad.launches
        draws = tp.draw_batch(gen, 64, pts.shape[0], cfg, train=True,
                              n_valid=n)
        step.train_step_fused(pts, q, n, gt, draws)
        torch.cuda.synchronize()
        assert pooled_tail_grad.launches - before == tails, run
