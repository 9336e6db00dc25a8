"""Port parity: checkpoints move both ways between the packages.

The port writes the JAX package's flat-npz layout (``train/checkpoint.py``
with ``models/weights.flax_from_state_dict`` and
``sgd_state_to_checkpoint``): a file the port writes loads with the JAX
package's ``load_state(strict=True)`` against a JAX ``Trainer`` template,
and a file JAX writes loads into the port, every array bit for bit
(parameters, batch statistics, momentum trace, step count). The small
training options are ``tests/test_trainer.py``'s.
"""

import os

import numpy as np
import pytest

from points2surf_tpu_torch.train import checkpoint as tckpt
from points2surf_tpu_torch.train.trainer import Trainer as TorchTrainer
from test_torch_trainer import train_opt

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.train import checkpoint as jckpt  # noqa: E402

def _assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_port_checkpoint_loads_in_jax(tmp_path):
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer

    tr = TorchTrainer(train_opt(str(tmp_path / "port")), device="cpu")
    tr.train()  # one epoch: momentum and count are non-zero
    path = str(tmp_path / "port" / "models" / "t_model.npz")
    flat = tckpt.load_state(path)
    assert flat["['opt_state'][1].count"] == tr.steps_per_epoch == 3

    template = JaxTrainer(train_opt(str(tmp_path / "jax"))).state_dict()
    state = jckpt.load_state(path, template, strict=True)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    assert {jax.tree_util.keystr(p) for p, _ in leaves} == set(flat)
    for p, leaf in leaves:
        _assert_bitwise(np.asarray(leaf), flat[jax.tree_util.keystr(p)])
    assert any(np.abs(v).max() > 0 for k, v in flat.items()
               if k.startswith("['opt_state'][0]"))


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A JAX Trainer's state with a random momentum trace and count 5,
    written by the JAX package, restores into the port at epoch 5."""
    from points2surf_tpu.train.trainer import Trainer as JaxTrainer

    rng = np.random.RandomState(0)
    state = JaxTrainer(train_opt(str(tmp_path / "jax"))).state_dict()
    state["opt_state"] = jax.tree_util.tree_map(
        lambda x: (np.asarray(5, x.dtype) if x.ndim == 0 else
                   rng.randn(*x.shape).astype(x.dtype)), state["opt_state"])
    snap = str(tmp_path / "jax" / "t_model_4.npz")
    jckpt.save_state(snap, state)
    tr = TorchTrainer(train_opt(str(tmp_path / "port"), nepoch=6,
                                refine=snap), device="cpu")
    assert tr.start_epoch == 5 and tr.steps.step == 5
    assert tr.global_step == 5 * tr.steps_per_epoch
    with np.load(snap) as data:
        want = {k: data[k] for k in data.files}
    got = tr.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        _assert_bitwise(np.asarray(got[k]), v)


@pytest.mark.parametrize("path", [
    "models/vanilla_model_49.npz", "models/vanilla_model.npz",
    "t_model_0.npz", "a_b_7.pth", "model_12",
])
def test_epoch_from_filename_matches_jax(path):
    assert (tckpt.epoch_from_filename(path)
            == jckpt.epoch_from_filename(path))


def test_snapshot_epochs_match_jax():
    for nepoch in (1, 3, 150, 1200):
        got = [e for e in range(nepoch) if tckpt.is_snapshot_epoch(e, nepoch)]
        assert got == [e for e in range(nepoch)
                       if jckpt.is_snapshot_epoch(e, nepoch)]


def test_save_state_is_atomic_and_flat(tmp_path):
    """save_state leaves no temporary file; flatten/unflatten invert."""
    tree = {"params": {"a": {"linear": {"kernel": np.ones((2, 3),
                                                          np.float32)}}}}
    flat = tckpt.flatten(tree)
    assert list(flat) == ["['params']['a']['linear']['kernel']"]
    path = str(tmp_path / "x" / "s.npz")
    tckpt.save_state(path, flat)
    assert os.listdir(tmp_path / "x") == ["s.npz"]
    back = tckpt.unflatten(tckpt.load_state(path), "['params']")
    np.testing.assert_array_equal(back["a"]["linear"]["kernel"],
                                  tree["params"]["a"]["linear"]["kernel"])
    with pytest.raises(KeyError):
        tckpt.load_state(path, ["['params']['b']"])
    assert tckpt.load_state(path, ["['params']['b']"], strict=False) == {}
