"""Port: tensor parallelism over a ``model`` axis (``parallel/sharding.py``,
``parallel/mesh.make_mesh``).

The rule: ``param_spec`` against the JAX package's on the same shapes and
mesh sizes, ``partition_params`` on a module (the cases of
``tests/test_sharding.py``), and the blocks of the bridged parameters of a
real model against the shards that JAX's ``partition_params`` puts on each
device of a ``(1, model)`` mesh (rank-major blocks).

The grid runs ``tests/_torch_parallel_worker.py``'s ``grid`` job on gloo
ranks on the CPU, one intra-op thread each, at ``__graft_entry__.
_dryrun_multichip_impl``'s configuration: net 256, ``min_dim=128`` (so
every conv2, conv3, wide FC layer and its BatchNorm is sharded), 32 patch
points, 48 sub-sample points, 8 rows per data rank, vanilla and shared
transformers, on a ``1 x 2`` and a ``2 x 2`` grid. Each run first sweeps 64
queries (``make_sdf_query_fn(mesh=)``), then takes one fused train step
with JAX's draws injected (each data rank keeps its rows). Held against:

* JAX's single-device step on the whole batch: losses rtol 1e-4, the
  gradients gathered whole as ``tests/test_torch_train.py`` holds them
  (rtol 1e-3, atol 1e-3 * max|g| of the tensor), the parameters and
  running statistics after the step rtol 1e-4 / atol 1e-6;
* the port's one-process step (the same job on a ``1 x 1`` grid): the same
  tolerances, and the running statistics rtol 1e-5 / atol 1e-6 (two
  summation orders of the same fp32 batch moments);
* JAX's single-device ``make_sdf_query_fn``: rtol / atol 1e-4;
* each other: every rank gathers the same state, bit for bit.

The spatial transformers' last layers start at zero, as in the train
parity tests (near-tied max-pool args otherwise flip between summation
orders).

The multi-scale encoder (the ``feat`` job: fc0, conv3 and conv4 through
the column-parallel dense layers) and bf16 activations (the column blocks
gathered in bf16) run on a ``2 x 2`` grid against one process; the
evaluator under a model axis writes on model rank 0 only.

``model=1`` (``make_mesh(model=1)`` on two ranks) takes data parallelism's
path: the same collectives on the same shapes and groups, and
bit-identical results.

``cuda``-marked: a ``1 x 2`` grid of two gloo ranks sharing the card, the
kernels on each rank's column slice, against the one-process step on the
card.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.models.p2s import PointsToSurfModel
from points2surf_tpu_torch.models.pointnet import BN, PLinear
from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.parallel import (
    distributed, make_mesh, param_spec, partition_like, partition_params)
from points2surf_tpu_torch.parallel.distributed import Grid
from points2surf_tpu_torch.parallel.sharding import (
    BLOCKS, COLUMNS, REPLICATED, jax_shape)
from test_torch_parallel import (  # noqa: F401  (cuda_device: a fixture)
    _assert_grads, _assert_ranks_equal, _assert_state, _identity_state,
    _step_job, cuda_device, run_ranks)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
NET = 256
MIN_DIM = 128
ROWS = 8  # per data rank
N = 4096
N_QUERIES = 64
KW = dict(points_per_patch=32, sub_sample_size=48, subsample_candidates=4)
VARIANTS = {"vanilla": {}, "shared": {"shared_transformation": True}}
GRIDS = [(1, 2, "vanilla"), (1, 2, "shared"), (2, 2, "vanilla"),
         (2, 2, "shared")]
GRID_IDS = [f"{d}x{m}-{v}" for d, m, v in GRIDS]


# -- the rule, in one process ------------------------------------------------

@contextlib.contextmanager
def installed(grid):
    """``grid`` as the process's layout (what ``make_mesh`` does on a
    rank), then none again."""
    distributed.set_grid(grid)
    try:
        yield grid
    finally:
        distributed.set_grid(None)


def test_grid_layout():
    """Rank ``d * model + m`` of JAX's ``devices.reshape(data, model)``;
    the helpers read the installed grid."""
    g = Grid(data=4, model=2, rank=5)
    assert (g.data_index, g.model_index) == (2, 1)
    assert g.shape == {"data": 4, "model": 2}
    try:
        one = make_mesh()  # a world of one: a 1 x 1 grid, no model axis
        assert one.shape == {"data": 1, "model": 1}
        assert distributed.current_grid() is one
        assert distributed.model_size() == 1 and distributed.data_size() == 1
        with pytest.raises(ValueError):
            make_mesh(model=2)
    finally:
        distributed.set_grid(None)
    with installed(g):
        assert (distributed.data_size(), distributed.model_size()) == (4, 2)
        assert (distributed.data_rank(), distributed.model_rank()) == (2, 1)
    assert (distributed.data_size(), distributed.model_size()) == (1, 1)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
@pytest.mark.parametrize("min_dim", [128, 512])
def test_param_spec_matches_jax(model, min_dim):
    jax = pytest.importorskip("jax")
    from points2surf_tpu.parallel.mesh import make_mesh as jax_mesh
    from points2surf_tpu.parallel.sharding import param_spec as jax_spec

    mesh = jax_mesh(jax.devices()[:8 // model * model], model=model)
    grid = Grid(data=8 // model, model=model)
    for shape in [(128, 512), (512,), (16, 16), (16,), (64, 128), (128,),
                  (256, 4096), (1024, 1000), (1000,), (3, 64, 1024), ()]:
        leaf = np.zeros(shape, np.float32)
        want = tuple(jax_spec((), leaf, mesh, min_dim))
        assert param_spec((), leaf, grid, min_dim) == want, shape
        assert param_spec((), shape, grid, min_dim) == want, shape


@pytest.mark.parametrize("index", [0, 1])
def test_partition_params_tp(index):
    """Wide layers hold their model rank's rows of dim 0 (the JAX kernel's
    columns), narrow ones stay whole."""
    torch.manual_seed(0)
    mod = torch.nn.Module()
    mod.wide = PLinear(128, 512, conv=True)
    mod.wide_bn = BN(512)
    mod.narrow = PLinear(16, 16, conv=False)
    with torch.no_grad():
        mod.wide_bn.running_mean.uniform_()
    full = {k: v.clone() for k, v in mod.state_dict().items()}
    grid = Grid(data=1, model=2, rank=index)
    assert param_spec((), jax_shape(mod.wide.weight), grid) == COLUMNS
    assert param_spec((), jax_shape(mod.wide.bias), grid) == BLOCKS
    assert param_spec((), jax_shape(mod.narrow.weight), grid) == REPLICATED
    with pytest.raises(ValueError):  # a grid that is not the installed one
        partition_params(mod, grid, min_dim=512)
    assert not mod.wide.sharded and mod.wide.weight.shape == (512, 128, 1)
    with installed(grid):
        partition_params(mod, grid, min_dim=512)
    assert mod.wide.sharded and mod.wide_bn.sharded
    assert not mod.narrow.sharded
    rows = slice(256 * index, 256 * (index + 1))
    got = mod.state_dict()
    for k in ("wide.weight", "wide.bias", "wide_bn.weight", "wide_bn.bias",
              "wide_bn.running_mean", "wide_bn.running_var"):
        assert torch.equal(got[k], full[k][rows]), k
    for k in ("narrow.weight", "narrow.bias", "wide_bn.num_batches_tracked"):
        assert torch.equal(got[k], full[k]), k
    assert mod.wide.weight.shape == (256, 128, 1)
    assert isinstance(mod.wide.weight, torch.nn.Parameter)
    assert partition_like(full, grid, 512).keys() == got.keys()
    assert all(torch.equal(partition_like(full, grid, 512)[k], v)
               for k, v in got.items())


def test_sgd_state_loads_onto_a_grid():
    """A checkpoint's momentum trace bridged and then partitioned
    (``partition_like``) gives each model rank its blocks, and gathering
    them (``torch.cat`` of the ranks' blocks) gives the whole trace
    back."""
    from points2surf_tpu_torch.models.weights import (
        sgd_state_from_checkpoint, sgd_state_to_checkpoint)

    torch.manual_seed(1)
    model = PointsToSurfModel(net_size_max=NET, output_dim=2)
    buffers = {k: torch.randn_like(p) for k, p in model.named_parameters()}
    flat = sgd_state_to_checkpoint(buffers, 7)
    blocks = []
    for index in range(2):
        grid = Grid(data=1, model=2, rank=index)
        got, count = sgd_state_from_checkpoint(flat)
        got = partition_like(got, grid, MIN_DIM)
        assert count == 7
        want = partition_like(buffers, grid, MIN_DIM)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        blocks.append(got)
    split = [k for k, v in buffers.items() if blocks[0][k].shape != v.shape]
    assert "feat_global.conv3.weight" in split and "fc1_local.bias" in split
    for k, v in buffers.items():
        whole = (torch.cat([b[k] for b in blocks]) if k in split
                 else blocks[0][k])
        assert torch.equal(whole, v), k


def test_partition_matches_jax_shards():
    """The bridged blocks of a real model on each model rank equal the
    shards JAX's ``partition_params`` / ``partition_like`` put on the
    devices of that model index, and the port's model partitions to the
    same state."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    pytest.importorskip("flax")
    from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S
    from points2surf_tpu.parallel.mesh import make_mesh as jax_mesh
    from points2surf_tpu.parallel.sharding import (
        partition_like as jax_like, partition_params as jax_params)

    from points2surf_tpu_torch.models.weights import state_dict_from_flax

    m = JaxP2S(net_size_max=NET, output_dim=2)
    dummy = {"patch_pts_ps": jnp.zeros((2, 32, 3)),
             "pts_sub_sample_ms": jnp.zeros((2, 48, 3)),
             "imp_surf_query_point_ms": jnp.zeros((2, 3))}
    v = jax.jit(m.init, static_argnums=2)(jax.random.key(0), dummy, True)
    mesh = jax_mesh(jax.devices()[:2], model=2)
    sharded = (jax_params(v["params"], mesh, min_dim=MIN_DIM),
               jax_like(v["batch_stats"], v["params"], mesh,
                        min_dim=MIN_DIM))
    whole = jax.tree.map(np.asarray, (v["params"], v["batch_stats"]))
    full = state_dict_from_flax(*whole)
    for index, dev in enumerate(mesh.devices[0]):
        local = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == dev), sharded)
        want = state_dict_from_flax(*local)
        grid = Grid(data=1, model=2, rank=index)
        got = partition_like(full, grid, MIN_DIM)
        assert got.keys() == want.keys()
        for k, t in want.items():
            assert torch.equal(got[k], t), k
        model = PointsToSurfModel(net_size_max=NET, output_dim=2)
        model.load_state_dict(full)
        with installed(grid):
            partition_params(model, grid, min_dim=MIN_DIM)
        for k, t in model.state_dict().items():
            assert torch.equal(t, want[k]), k
        assert any(t.shape != full[k].shape for k, t in want.items())


# -- the grid, on gloo ranks ---------------------------------------------------

def _data(batch):
    """The cloud, ``batch`` train queries and their ground truth, and the
    sweep's queries (the same for every batch)."""
    rng = np.random.RandomState(0)
    cloud = np.load(CLOUD)[:, :3].astype(np.float32)
    pts = cloud[rng.choice(len(cloud), N, replace=False)]
    queries = pts[rng.choice(N, N_QUERIES, replace=False)] + rng.randn(
        N_QUERIES, 3).astype(np.float32) * 0.02
    q = pts[rng.choice(N, batch, replace=False)] + rng.randn(
        batch, 3).astype(np.float32) * 0.01
    gt = (rng.randn(batch) * 0.05).astype(np.float32)
    return pts, q.astype(np.float32), gt, queries.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model(variant):
    """A seeded JAX model with zero-started transformer last layers, its
    running statistics after one train-mode batch, and its single-device
    query of the test's queries: (model, params, stats, query, draws)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    pytest.importorskip("flax")
    from test_torch_patches import jax_draws
    from test_torch_train import _identity_transformers

    from points2surf_tpu.infer.query import make_sdf_query_fn as jax_query
    from points2surf_tpu.models.p2s import PointsToSurfModel as JaxP2S
    from points2surf_tpu.ops import patches as jp

    m = JaxP2S(net_size_max=NET, output_dim=2, **VARIANTS[variant])
    rng = np.random.RandomState(1)
    init = {"patch_pts_ps": jnp.asarray(rng.randn(16, 32, 3) * 0.3,
                                        jnp.float32),
            "pts_sub_sample_ms": jnp.asarray(rng.randn(16, 48, 3) * 0.3,
                                             jnp.float32),
            "imp_surf_query_point_ms": jnp.zeros((16, 3), jnp.float32)}
    v = jax.jit(m.init, static_argnums=2)(jax.random.key(0), init, True)
    params = _identity_transformers(v["params"])
    stats = jax.jit(lambda p, bs: m.apply(
        {"params": p, "batch_stats": bs}, init, True,
        mutable=["batch_stats"])[1]["batch_stats"])(params, v["batch_stats"])
    pts, _, _, queries = _data(ROWS)
    qkey = jax.random.key(7)
    old = os.environ.get("P2S_EVAL_APPROX_SELECT")
    os.environ["P2S_EVAL_APPROX_SELECT"] = "0"
    jax.clear_caches()
    try:
        dists = np.asarray(jax_query(m, OUTPUTS, jp.PatchConfig(**KW),
                                     fixed_radius=False)(
            params, stats, jnp.asarray(pts), jnp.asarray(queries),
            jnp.int32(N), qkey))
    finally:
        if old is None:
            del os.environ["P2S_EVAL_APPROX_SELECT"]
        else:
            os.environ["P2S_EVAL_APPROX_SELECT"] = old
        jax.clear_caches()
    return m, params, stats, dists, jax_draws(qkey, N_QUERIES, N,
                                              tp.PatchConfig(**KW), False)


def _jax_reference(variant, batch):
    """JAX's single-device step on ``batch`` rows (and ``_jax_model``'s
    query)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    optax = pytest.importorskip("optax")
    from test_torch_patches import jax_train_draws

    from points2surf_tpu.models import losses as JL
    from points2surf_tpu.ops import patches as jp

    from points2surf_tpu_torch.models.weights import state_dict_from_flax

    m, params, stats, dists, query_draws = _jax_model(variant)
    cfg = jp.PatchConfig(**KW)
    tx = optax.sgd(0.01, momentum=0.9)
    weights = {o: 1.0 for o in OUTPUTS}
    pts, q, gt, _ = _data(batch)

    @jax.jit
    def step(p, bs, key):
        bt = jp.extract_patches(jnp.asarray(pts), jnp.asarray(q),
                                jnp.int32(N), key, cfg=cfg, train=True)
        bt["imp_surf_ms"] = jnp.asarray(gt)
        bt["imp_surf_magnitude_ms"] = jnp.abs(bt["imp_surf_ms"])
        bt["imp_surf_dist_sign_ms"] = (bt["imp_surf_ms"] >= 0.0).astype(
            jnp.float32)

        def loss_fn(p, bs):
            pred, mutated = m.apply({"params": p, "batch_stats": bs}, bt,
                                    True, mutable=["batch_stats"])
            ll = JL.compute_loss(pred, bt, OUTPUTS, weights, False)
            return sum(ll), (jnp.stack(ll), mutated["batch_stats"])

        (_, (ll, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, bs)
        updates, _ = tx.update(grads, tx.init(p), p)
        return ll, grads, optax.apply_updates(p, updates), new_bs

    key = jax.random.key(21)
    ll, grads, new_p, new_bs = step(params, stats, key)
    return {
        "state": state_dict_from_flax(*jax.tree.map(np.asarray,
                                                    (params, stats))),
        "draws": jax_train_draws(key, batch, N, tp.PatchConfig(**KW)),
        "query_draws": query_draws,
        "losses": np.asarray(ll), "query": dists,
        "grads": {k: t for k, t in state_dict_from_flax(
            jax.tree.map(np.asarray, grads)).items()
            if not k.endswith("num_batches_tracked")},
        "after": state_dict_from_flax(
            *jax.tree.map(np.asarray, (new_p, new_bs))),
    }


def _grid_job(ref, data, model, variant, device="cpu"):
    pts, q, gt, queries = _data(ROWS * data)
    return dict(mode="grid", data=data, model=model, min_dim=MIN_DIM,
                state=ref["state"], cfg=KW, query_cfg=KW, outputs=OUTPUTS,
                model_kw=dict(net_size_max=NET, output_dim=2,
                              **VARIANTS[variant]),
                lr=0.01, momentum=0.9, pts=torch.from_numpy(pts), n_valid=N,
                q=[torch.from_numpy(q)], gt=[torch.from_numpy(gt)],
                draws=[ref["draws"]], steps=1,
                queries=torch.from_numpy(queries),
                query_draws=ref["query_draws"], device=device)


@pytest.fixture(scope="module", params=GRIDS, ids=GRID_IDS)
def grid_run(request, tmp_path_factory):
    """The grid's ranks, the JAX references and the one-process run."""
    from _torch_parallel_worker import _grid

    data, model, variant = request.param
    ref = _jax_reference(variant, ROWS * data)
    job = _grid_job(ref, data, model, variant)
    outs = run_ranks(tmp_path_factory.mktemp("grid"), job,
                     world=data * model)
    one = _one_process(_grid, job)
    return {"data": data, "model": model, "variant": variant, "outs": outs,
            "ref": ref, "one": one}


def _mean_loss(outs, data, model):
    """The data ranks' mean losses (each model rank of a data rank holds
    the same)."""
    per_data = [outs[d * model]["losses"][0] for d in range(data)]
    for d in range(data):
        for m in range(model):
            assert torch.equal(outs[d * model + m]["losses"][0],
                               per_data[d])
    return (sum(per_data) / data).numpy()


def test_grid_shards_by_the_rule(grid_run):
    """At net 256 / min_dim 128 every layer of width >= 128 holds a block
    (every conv2 and conv3, the trunks' fc1, the feature transformers' fc3,
    the head's fc1 layers, their BatchNorms); no other does."""
    outs = grid_run["outs"]
    shards = outs[0]["shards"]
    assert all(o["shards"] == shards for o in outs)
    assert grid_run["one"]["shards"] == []
    model = PointsToSurfModel(net_size_max=NET, output_dim=2,
                              **VARIANTS[grid_run["variant"]])
    want = sorted(name for name, mod in model.named_modules()
                  if isinstance(mod, (PLinear, BN))
                  and mod.weight.shape[0] >= MIN_DIM)
    assert shards == want
    assert {"feat_global.conv2", "feat_global.conv3", "feat_local.stn2.fc3",
            "fc1_global", "bn1_local"} <= set(shards)


def test_grid_replicate_array(grid_run):
    """Every rank holds rank 0's tensor."""
    for o in grid_run["outs"]:
        assert torch.equal(o["replicated"], torch.zeros(3))


def test_grid_step_matches_jax(grid_run):
    outs, ref = grid_run["outs"], grid_run["ref"]
    _assert_ranks_equal(outs)
    np.testing.assert_allclose(
        _mean_loss(outs, grid_run["data"], grid_run["model"]),
        ref["losses"], rtol=1e-4)
    _assert_grads(outs[0]["grads"], ref["grads"])
    _assert_state(outs[0]["states"][0], ref["after"])


def test_grid_step_matches_one_process(grid_run):
    outs, one = grid_run["outs"], grid_run["one"]
    np.testing.assert_allclose(
        _mean_loss(outs, grid_run["data"], grid_run["model"]),
        one["losses"][0].numpy(), rtol=1e-4)
    _assert_grads(outs[0]["grads"], one["grads"])
    _assert_state(outs[0]["states"][0], one["states"][0])


def test_grid_running_stats_match_one_process(grid_run):
    outs, one = grid_run["outs"], grid_run["one"]
    keys = [k for k in one["states"][0] if k.endswith(
        ("running_mean", "running_var"))]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_allclose(outs[0]["states"][0][k].numpy(),
                                   one["states"][0][k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_grid_query_matches_jax(grid_run):
    outs, ref, one = grid_run["outs"], grid_run["ref"], grid_run["one"]
    for o in outs:
        assert o["query"].shape == (N_QUERIES,)
        assert torch.equal(o["query"], outs[0]["query"])
    np.testing.assert_allclose(outs[0]["query"].numpy(), ref["query"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0]["query"].numpy(),
                               one["query"].numpy(), rtol=1e-4, atol=1e-4)


def _zero_transformers(model):
    from points2surf_tpu_torch.models.pointnet import _STNTrunk

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    return model


def _one_process(fn, job):
    """The job's run in this process on a ``1 x 1`` grid, one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(dict(job, data=1, model=1), torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
        distributed.set_grid(None)


def test_grid_multiscale_matches_one_process(tmp_path):
    """The multi-scale encoder (``num_scales=2``: the transformers' fc0,
    conv3 and conv4 through the column-parallel dense layers, then the
    scale pool) on a ``2 x 2`` grid against one process: the train-mode
    and eval codewords, the gradients gathered whole and the running
    statistics."""
    from _torch_parallel_worker import _feat

    from points2surf_tpu_torch.models.pointnet import PointNetFeat

    kw = dict(net_size_max=NET, output_size=NET, num_scales=2)
    torch.manual_seed(5)
    feat = _zero_transformers(PointNetFeat(**kw))
    rng = np.random.RandomState(6)
    rows = 2 * ROWS
    job = dict(mode="feat", data=2, model=2, min_dim=MIN_DIM, feat_kw=kw,
               state=feat.state_dict(),
               x=torch.from_numpy((rng.randn(rows, 32, 3) * 0.3)
                                  .astype(np.float32)),
               w=torch.from_numpy(rng.randn(rows, NET * 4)
                                  .astype(np.float32)))
    outs = run_ranks(tmp_path, job, world=4)
    one = _one_process(_feat, job)
    _assert_ranks_equal([{"grads": o["grads"], "states": [o["state"]]}
                         for o in outs])
    assert "stn1.fc0.weight" in set(outs[0]["grads"])
    for key in ("code", "eval"):
        got = torch.cat([outs[0][key], outs[2][key]])
        assert torch.equal(outs[1][key], outs[0][key])
        np.testing.assert_allclose(got.numpy(), one[key].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(one[key].abs().max()),
                                   err_msg=key)
    _assert_grads(outs[0]["grads"], one["grads"])
    _assert_state(outs[0]["state"], one["state"])


def test_grid_bf16_activations_matches_one_process(tmp_path):
    """bf16 activations (the literal stack: the column blocks gathered in
    bf16) on a ``2 x 2`` grid against one process in the same mode."""
    from _torch_parallel_worker import _grid

    torch.manual_seed(3)
    base = _zero_transformers(PointsToSurfModel(net_size_max=NET,
                                                output_dim=2))
    cfg = tp.PatchConfig(**KW)
    gen = torch.Generator().manual_seed(4)
    ref = {"state": base.state_dict(),
           "draws": tp.draw_batch(gen, 2 * ROWS, N, cfg, train=True,
                                  n_valid=N),
           "query_draws": tp.draw_batch(gen, N_QUERIES, N, cfg, n_valid=N)}
    job = _grid_job(ref, 2, 2, "vanilla")
    job["model_kw"]["dtype"] = torch.bfloat16
    outs = run_ranks(tmp_path, job, world=4)
    one = _one_process(_grid, job)
    _assert_ranks_equal(outs)
    # as tests/test_torch_dtype.py holds a bf16 step (u = 2^-8): the data
    # ranks' fp32 batch statistics round apart from one process's by a bf16
    # ulp here and there, and that propagates (measured: losses equal, the
    # query bit-identical, gradients 4.0u max|g| apart at worst, cosine
    # 0.99997)
    u = 2.0 ** -8
    np.testing.assert_allclose(_mean_loss(outs, 2, 2),
                               one["losses"][0].numpy(), rtol=32 * u)
    np.testing.assert_allclose(outs[0]["query"].numpy(),
                               one["query"].numpy(), rtol=1e-4, atol=1e-4)
    names = sorted(one["grads"])
    got, want = (torch.cat([g[k].reshape(-1).double() for k in names])
                 for g in (outs[0]["grads"], one["grads"]))
    g_max = float(want.abs().max())
    assert float(got @ want / (got.norm() * want.norm())) > 0.999
    assert float((got - want).abs().max()) <= 8 * u * g_max
    for k, v in one["states"][0].items():
        d = float((outs[0]["states"][0][k].double() - v.double()).abs().max())
        if k.endswith(("running_mean", "running_var")):
            assert d <= u * float(v.abs().max()), k
        elif v.is_floating_point():  # p - lr g, g within 2 max|g|
            assert d <= 2 * 0.01 * g_max, k


@pytest.mark.parametrize("index", [0, 1])
def test_evaluator_writes_on_model_rank_0(tmp_path, index):
    """Under a model axis every model rank of a data rank evaluates the
    same shapes; only model rank 0 writes them."""
    from test_torch_evaluator import ABC, _eval_opt, _files
    from test_torch_trainer import train_opt

    from points2surf_tpu_torch.infer import evaluator as tev
    from points2surf_tpu_torch.train import checkpoint as tckpt
    from points2surf_tpu_torch.train.trainer import Trainer

    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"))
    tckpt.save_state(os.path.join(models, "t_model.npz"),
                     Trainer(opt, device="cpu").state_dict())
    tckpt.save_params_namespace(os.path.join(models, "t_params.json"), opt)
    e_opt = _eval_opt(ABC, models, str(tmp_path / "out"), False)
    e_opt.patches_per_shape = e_opt.batchSize = 8
    with installed(Grid(data=1, model=2, rank=index)):
        tev.points_to_surf_eval(e_opt, device="cpu")
    written = [f for f in _files(str(tmp_path / "out"))
               if f.endswith((".xyz.npy", ".idx"))]
    if index == 0:
        assert written
    else:
        assert written == []


def test_model1_is_data_parallelism(tmp_path):
    """``make_mesh(model=1)`` on two ranks: data parallelism's collectives
    (names, shapes, groups) and results, bit for bit."""
    job = dict(_step_job(_identity_state("max"), "max", seed=5),
               mode="model1", steps=1)
    outs = run_ranks(tmp_path, job)
    for o in outs:
        (first, log1), (second, log2) = o["runs"]
        assert log1 == log2 and len(log1) > 10
        assert not any(name == "new_group" for name, _, _ in log2)
        assert all(not group for _, _, group in log2)
        for k in ("losses", "states"):
            for a, b in zip(first[k], second[k]):
                if isinstance(a, dict):
                    assert all(torch.equal(a[n], b[n]) for n in a), k
                else:
                    assert torch.equal(a, b), k
        assert all(torch.equal(first["grads"][n], second["grads"][n])
                   for n in first["grads"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["highest", "default"])
def test_grid_on_one_card_matches_one_process(tmp_path, cuda_device,
                                              monkeypatch, mode):
    """Two gloo ranks sharing the card as a 1 x 2 grid: the kernels on
    each rank's 128 columns (``chain_pool`` in the sweep, ``pooled_tail``
    in the step; in the bf16 mode ``chain_fused`` and the bf16 tail, whose
    256-column slice the 128 columns fill half), against the one-process
    run on the card in the same mode."""
    from _torch_parallel_worker import _grid

    for env in ("P2S_EVAL_CHAIN_PREC", "P2S_PALLAS_TAIL_PREC"):
        monkeypatch.setenv(env, mode)  # the ranks inherit it
    torch.manual_seed(3)
    base = _zero_transformers(PointsToSurfModel(
        net_size_max=NET, output_dim=2, shared_transformation=True))
    cfg = tp.PatchConfig(**KW)
    pts, _, _, queries = _data(ROWS)
    gen = torch.Generator().manual_seed(4)
    ref = {"state": base.state_dict(),
           "draws": tp.draw_batch(gen, ROWS, N, cfg, train=True, n_valid=N),
           "query_draws": tp.draw_batch(gen, N_QUERIES, N, cfg, n_valid=N)}
    job = _grid_job(ref, 1, 2, "shared", device="cuda")
    outs = run_ranks(tmp_path, job)
    try:
        one = _grid(dict(job, data=1, model=1), cuda_device)
    finally:
        distributed.set_grid(None)
    bf16 = mode == "default"
    for o in outs:  # five chains per forward, five tails per step
        assert o["chain_launches"] == ((0, 0, 5) if bf16 else (5, 5, 0))
        assert o["tail_launches"] == ((0, 5) if bf16 else (5, 0))
    np.testing.assert_allclose(_mean_loss(outs, 1, 2),
                               one["losses"][0].numpy(), rtol=1e-4)
    _assert_grads(outs[0]["grads"], one["grads"])
    np.testing.assert_allclose(outs[0]["query"].numpy(),
                               one["query"].numpy(), rtol=1e-4, atol=1e-4)
