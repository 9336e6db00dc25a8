"""Port: data parallelism across processes (``points2surf_tpu_torch/parallel``).

The two-process tests start two ranks of ``tests/_torch_parallel_worker.py``
on the CPU, joined through gloo and a ``file://`` store under the test's
temporary directory, one intra-op thread each. The JAX package computes
every batch statistic over the global batch (its data mesh); the port sums
them across ranks, so two ranks on halves of a batch must take the step of
one process (or of JAX's single device) on the whole batch:

* the fused train step against JAX's, with JAX's draws injected and the
  rank's rows of them taken (``TrainDraws.rows``), with the max and the sum
  pool: the ranks' mean losses rtol 1e-4, the (averaged) gradients of the
  first step as ``tests/test_torch_train.py`` holds them (rtol 1e-3, atol
  1e-3 * max|g| of the tensor), the state after the first step rtol 1e-4
  / atol 1e-6 (the second step's losses show the momentum carried), and
  every tensor of the state after each step equal on both ranks bit for
  bit;
* the same against the port's one-process step with the port's own draws
  (each rank draws the global batch and keeps its rows), in kNN and in
  ball mode;
* a two-process ``Trainer`` run through ``cli.full_train``: equal final
  parameters on both ranks, and rank 0 alone writes the checkpoints, the
  params JSON and the TensorBoard log.

The spatial transformers' last layers start at zero, as in the train parity
tests: at a random init they amplify rounding enough to flip near-tied max
pool args between two summation orders. After the first step they no
longer start at zero, so the state is held after that step.

In one process: the evaluator's round-robin split of the shapes against the
JAX evaluator with the same ``(proc, n_proc)``, the rank slices against the
JAX package's (``tests/test_distributed.py``), a rank's share of the ball
priorities, and ``initialize`` outside a launch.

``cuda``-marked: two gloo ranks sharing one card run the step with the
``pooled_tail`` kernel and match the one-process step on the card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from points2surf_tpu_torch.ops import patches as tp
from points2surf_tpu_torch.parallel import distributed, mesh
from test_torch_evaluator import jax_exact  # noqa: F401  (a fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")
CLOUD = os.path.join(ROOT, "datasets", "abc_minimal", "04_pts",
                     "00011084_fddd53ce45f640f3ab922328_trimesh_019.xyz.npy")
OUTPUTS = ("imp_surf_magnitude", "imp_surf_sign")
NET = 64
B = 16  # global rows: 8 per rank
N = 4096
KW = dict(points_per_patch=32, sub_sample_size=64, subsample_candidates=4)
STEPS = 2


def run_ranks(tmp_path, job, world=2, timeout=240):
    """Run ``job`` on ``world`` worker ranks; their results, by rank."""
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp_path / "store"),
         str(job_path), str(tmp_path / f"out{r}.pt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    cloud = np.load(CLOUD)[:, :3].astype(np.float32)
    pts = cloud[rng.choice(len(cloud), N, replace=False)]
    qs, gts = [], []
    for _ in range(STEPS):
        q = pts[rng.choice(N, B, replace=False)] + rng.randn(B, 3).astype(
            np.float32) * 0.01
        qs.append(torch.from_numpy(q.astype(np.float32)))
        gts.append(torch.from_numpy((rng.randn(B) * 0.05).astype(np.float32)))
    return torch.from_numpy(pts), qs, gts


def _step_job(state, sym_op, cfg=KW, **kw):
    pts, qs, gts = _data()
    return dict(mode="step", state=state, cfg=cfg, outputs=OUTPUTS,
                model_kw=dict(net_size_max=NET, output_dim=2, sym_op=sym_op,
                              shared_transformation=True),
                lr=0.01, momentum=0.9, pts=pts, n_valid=N, q=qs, gt=gts,
                steps=STEPS, **kw)


def _identity_state(sym_op):
    """A seeded port model with zero-started transformer last layers."""
    from points2surf_tpu_torch.models.p2s import PointsToSurfModel
    from points2surf_tpu_torch.models.pointnet import _STNTrunk

    torch.manual_seed(3)
    m = PointsToSurfModel(net_size_max=NET, output_dim=2, sym_op=sym_op,
                          shared_transformation=True)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, _STNTrunk):
                mod.fc3.weight.zero_()
                mod.fc3.bias.zero_()
    return m.state_dict()


def _assert_ranks_equal(outs):
    """The state after each step and the gradients, bit for bit on every
    rank."""
    for i, state in enumerate(outs[0]["states"]):
        for k, v in state.items():
            for o in outs[1:]:
                assert torch.equal(o["states"][i][k], v), (i, k)
    for k, g in outs[0]["grads"].items():
        for o in outs[1:]:
            assert torch.equal(o["grads"][k], g), k


def _assert_grads(got: dict, want: dict):
    """Gradients as ``tests/test_torch_train.py`` holds them."""
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got_g = got[name]
        if float(g.abs().max()) < 1e-6 * g_max:  # zero in exact arithmetic
            assert float(got_g.abs().max()) < 1e-6 * g_max, name
            continue
        np.testing.assert_allclose(got_g.numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(g.abs().max()),
                                   err_msg=name)


def _assert_state(got: dict, want: dict):
    for key, val in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def _mean_losses(outs, i):
    return (sum(o["losses"][i] for o in outs) / len(outs)).numpy()


@pytest.mark.parametrize("sym_op", ["max", "sum"])
def test_two_process_step_matches_jax(tmp_path, sym_op):
    jax = pytest.importorskip("jax")
    optax = pytest.importorskip("optax")
    pytest.importorskip("flax")
    from test_torch_patches import jax_train_draws
    from test_torch_train import _jax_init, _jax_step

    from points2surf_tpu_torch.models.weights import state_dict_from_flax

    pts, qs, gts = _data()
    m, params, stats = _jax_init("shared", sym_op)
    assert m.net_size_max == NET
    tx = optax.sgd(0.01, momentum=0.9)
    step = _jax_step(m, tx)
    keys = [jax.random.key(21 + i) for i in range(STEPS)]
    p, bs, opt = params, stats, tx.init(params)
    j_losses = []
    for i, key in enumerate(keys):
        p, bs, opt, ll, _, grads = step(p, bs, opt, pts.numpy(), qs[i].numpy(),
                                        gts[i].numpy(), key)
        j_losses.append(np.asarray(ll))
        if i == 0:
            j_grads = state_dict_from_flax(jax.tree.map(np.asarray, grads))
            j_state = state_dict_from_flax(
                *jax.tree.map(np.asarray, (p, bs)))
    draws = [jax_train_draws(k, B, N, tp.PatchConfig(**KW)) for k in keys]
    np_tree = jax.tree.map(np.asarray, (params, stats))
    outs = run_ranks(tmp_path, _step_job(state_dict_from_flax(*np_tree),
                                         sym_op, draws=draws))

    _assert_ranks_equal(outs)
    for i in range(STEPS):
        np.testing.assert_allclose(_mean_losses(outs, i), j_losses[i],
                                   rtol=1e-4)
    _assert_grads(outs[0]["grads"], {k: v for k, v in j_grads.items()
                                     if not k.endswith("num_batches_tracked")})
    _assert_state(outs[0]["states"][0], j_state)


@pytest.mark.parametrize("mode", ["knn", "ball"])
def test_two_process_step_matches_one_process(tmp_path, mode):
    """The port's own draws: each rank draws the global batch (in ball mode
    its dense selection's priorities too) and keeps its rows."""
    from _torch_parallel_worker import _step

    cfg = dict(KW, patch_radius=0.1) if mode == "ball" else KW
    job = _step_job(_identity_state("max"), "max", cfg=cfg, seed=5)
    outs = run_ranks(tmp_path, job)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _step(job, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)

    _assert_ranks_equal(outs)
    for i in range(STEPS):
        np.testing.assert_allclose(_mean_losses(outs, i),
                                   one["losses"][i].numpy(), rtol=1e-4)
    _assert_grads(outs[0]["grads"], one["grads"])
    _assert_state(outs[0]["states"][0], one["states"][0])


def test_two_process_trainer_rank0_writes(tmp_path):
    """``cli.full_train`` on two ranks (fused and mixed train batches and
    interleaved test batches, all split between the ranks); each rank is
    given its own directories, and rank 1's stay unwritten."""
    from test_torch_trainer import train_opt

    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(ROOT, "datasets", "abc_minimal"), data,
                    ignore=shutil.ignore_patterns("cache"))
    opts = [train_opt(str(tmp_path / f"rank{r}"), indir=data)
            for r in range(2)]
    outs = run_ranks(tmp_path, dict(mode="train", opts=opts))

    for k, v in outs[0]["state"].items():
        assert torch.equal(outs[1]["state"][k], v), k
    models0 = tmp_path / "rank0" / "models"
    assert (models0 / "t_model.npz").is_file()
    assert (models0 / "t_params.json").is_file()
    assert any(f.startswith("events.") for f in os.listdir(
        tmp_path / "rank0" / "logs" / "t"))
    assert not (tmp_path / "rank1").exists()


def test_evaluator_shards_match_jax(tmp_path, monkeypatch, jax_exact):
    """Each (proc, n_proc) share of three shapes: the files and distances
    of the JAX evaluator run as process ``proc`` of ``n_proc`` (its draws
    advance per batch the process runs, and so do the port's); every shape
    written once over the shares. The port takes the process group's share
    by default."""
    from test_torch_evaluator import _eval_opt, _files, _inject_jax_draws
    from test_torch_trainer import train_opt

    jax = jax_exact
    from points2surf_tpu.infer.evaluator import points_to_surf_eval
    from points2surf_tpu.train import checkpoint as jckpt
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer

    from points2surf_tpu_torch.infer import evaluator as tev

    data = str(tmp_path / "data")
    shutil.copytree(os.path.join(ROOT, "datasets", "abc_minimal"), data,
                    ignore=shutil.ignore_patterns("cache"))
    names = []
    for split in ("trainset.txt", "valset.txt"):
        with open(os.path.join(data, split)) as f:
            names += f.read().split()
    assert len(names) == 3
    with open(os.path.join(data, "three.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    models = str(tmp_path / "models")
    opt = train_opt(str(tmp_path / "train"))
    jckpt.save_state(os.path.join(models, "t_model.npz"),
                     JaxTrainer(opt).state_dict())
    jckpt.save_params_namespace(os.path.join(models, "t_params.json"), opt)

    written = []
    for proc in range(2):
        outs = {}
        for pkg in ("jax", "port"):
            e_opt = _eval_opt(data, models, str(tmp_path / f"{pkg}{proc}"),
                              False)
            e_opt.dataset = "three.txt"
            with monkeypatch.context() as mp:
                if pkg == "jax":
                    mp.setattr(jax, "process_count", lambda: 2)
                    mp.setattr(jax, "process_index", lambda p=proc: p)
                    points_to_surf_eval(e_opt)
                else:
                    _inject_jax_draws(mp, jax, e_opt.seed)
                    mp.setattr(distributed, "rank", lambda p=proc: p)
                    mp.setattr(distributed, "world_size", lambda: 2)
                    tev.points_to_surf_eval(e_opt, device="cpu")
            outs[pkg] = os.path.join(e_opt.outdir, "eval")
        files = _files(outs["jax"])
        assert _files(outs["port"]) == files
        for f in files:
            a, b = (os.path.join(outs[p], f) for p in ("port", "jax"))
            if f.endswith(".idx"):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), f
            elif f.endswith(".xyz.npy"):
                np.testing.assert_allclose(np.load(a), np.load(b), rtol=0,
                                           atol=1e-4, err_msg=f)
        written += [f for f in files if f.startswith("eval" + os.sep)
                    and f.endswith(".xyz.npy")]
    assert sorted(written) == sorted(os.path.join("eval", n + ".xyz.npy")
                                     for n in names)


@pytest.mark.parametrize("idx,world,multiple_of", [
    (np.arange(64), 4, 1), (np.arange(10), 4, 1), (np.arange(7), 1, 1),
    (np.arange(23), 2, 3), (np.arange(3), 4, 1)])
def test_rank_slices_match_jax(monkeypatch, idx, world, multiple_of):
    """``shard_host_batch`` / ``shard_host_tree`` / ``shard_batch`` take the
    JAX package's slices, the ragged remainder dropped."""
    pytest.importorskip("jax")
    from points2surf_tpu.parallel import distributed as jdist

    monkeypatch.setattr(jdist.jax, "process_count", lambda: world)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    got = []
    for r in range(world):
        monkeypatch.setattr(jdist.jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        want = jdist.shard_host_batch(idx, multiple_of)
        np.testing.assert_array_equal(
            distributed.shard_host_batch(idx, multiple_of), want)
        tree = {"i": idx, "t": torch.from_numpy(idx * 2.0)}
        jtree = jdist.shard_host_tree({"i": idx, "t": idx * 2.0},
                                      multiple_of)
        for sharded in (distributed.shard_host_tree(tree, multiple_of),
                        mesh.shard_batch(tree, multiple_of)):
            np.testing.assert_array_equal(sharded["i"], jtree["i"])
            np.testing.assert_array_equal(sharded["t"].numpy(), jtree["t"])
        got.append(want)
    per = len(idx) // world
    per -= per % multiple_of
    np.testing.assert_array_equal(np.concatenate(got), idx[:per * world])


def test_initialize_is_a_noop_outside_a_launch(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size(),
            distributed.local_rank()) == (0, 1, 0)
    assert distributed.is_main_process()
    t = torch.arange(4.0, requires_grad=True)
    assert distributed.global_sum(t) is t  # no collective
    assert distributed.mean_over_ranks_(t.detach()).tolist() == [0, 1, 2, 3]
    distributed.barrier("noop")
    model = torch.nn.Linear(2, 2)
    before = [p.clone() for p in model.parameters()]
    mesh.replicate(model)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))


def test_ball_rows_replay_the_global_draw():
    """A rank's share of ball priorities asks its source for the whole
    batch's blocks in the one-process order, and serves its own rows; a
    generator's source ends where the one-process selection leaves it."""
    total, cols, chunk = 23, 5, 4
    rows = torch.rand(total, cols)

    def recording(calls):
        def source(kind, index, shape):
            calls.append((kind, index, shape))
            return rows[index:index + shape[0]].clone()
        return tp.BallDraws(source)

    want_calls = []
    ball = recording(want_calls)
    for s in range(0, total, chunk):
        ball.block("rows", s, (min(chunk, total - s), cols))
    for lo, hi, local_chunk in ((0, 11, 4), (11, 22, 4), (5, 15, 3),
                                (0, 23, 8)):
        calls = []
        mine = recording(calls).rows(lo, hi, total, chunk)
        got = [mine.block("rows", s, (min(local_chunk, hi - lo - s), cols))
               for s in range(0, hi - lo, local_chunk)]
        assert torch.equal(torch.cat(got), rows[lo:hi])
        assert calls == want_calls

    g_one = torch.Generator().manual_seed(7)
    for s in range(0, total, chunk):
        torch.rand((min(chunk, total - s), cols), generator=g_one)
    for lo, hi in ((0, 11), (11, 22)):
        g = torch.Generator().manual_seed(7)
        mine = tp.BallDraws.from_generator(g).rows(lo, hi, total, chunk)
        for s in range(0, hi - lo, chunk):
            mine.block("rows", s, (min(chunk, hi - lo - s), cols))
        assert torch.equal(g.get_state(), g_one.get_state())


def test_train_draws_rows():
    """Per-row draws sliced, the shared decimation offset kept."""
    cfg = tp.PatchConfig(**KW)
    d = tp.draw_batch(torch.Generator().manual_seed(1), B, N, cfg, train=True,
                      n_valid=N)
    r = d.rows(4, 12, chunk=cfg.query_chunk)
    assert isinstance(r, tp.TrainDraws) and r.offset is d.offset
    assert torch.equal(r.logu, d.logu[4:12])
    assert torch.equal(r.rot, d.rot[4:12])
    u = tp.draw_batch(torch.Generator().manual_seed(1), B, N,
                      tp.PatchConfig(**KW, uniform_subsample=True),
                      n_valid=N)
    assert torch.equal(u.rows(0, 8, chunk=512).ids, u.ids[:8])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_one_process(tmp_path, cuda_device):
    """Two gloo ranks sharing the card, the ``pooled_tail`` kernel on each
    rank's rows (5 launches per step), against the one-process step on the
    card."""
    from _torch_parallel_worker import _step

    job = _step_job(_identity_state("max"), "max", seed=5, device="cuda")
    outs = run_ranks(tmp_path, job)
    one = _step(job, cuda_device)
    _assert_ranks_equal(outs)
    for o in outs:
        assert o["launches"] == 5 * STEPS
    for i in range(STEPS):
        np.testing.assert_allclose(_mean_losses(outs, i),
                                   one["losses"][i].numpy(), rtol=1e-4)
    _assert_grads(outs[0]["grads"], one["grads"])
    _assert_state(outs[0]["states"][0], one["states"][0])
