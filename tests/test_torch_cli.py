"""Port parity: the command lines. Every bundled experiment script parses
through the port's argument parsers into the namespace the JAX package's
parsers make, and names an entry point the port has under the same module
path (so a script runs on the port by swapping the package name)."""

import glob
import importlib.util
import os

import pytest

from points2surf_tpu_torch.cli import eval_args, train_args

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package's models need it
from points2surf_tpu.cli import eval_args as jeval  # noqa: E402
from points2surf_tpu.cli import train_args as jtrain  # noqa: E402
from test_cli_args import _script_args  # noqa: E402

EXPERIMENTS = os.path.join(os.path.dirname(__file__), "..", "experiments")
SCRIPTS = sorted(glob.glob(os.path.join(EXPERIMENTS, "*.sh")))


def _entry_module(path):
    with open(path) as f:
        lines = [ln for ln in f if not ln.lstrip().startswith("#")]
    return "".join(lines).split("python -m", 1)[1].split()[0]


@pytest.mark.parametrize("script", SCRIPTS, ids=os.path.basename)
def test_script_parses_like_jax(script):
    args = _script_args(script)
    port, ref = ((train_args, jtrain)
                 if os.path.basename(script).startswith("train_")
                 else (eval_args, jeval))
    assert vars(port.parse_arguments(args)) == vars(ref.parse_arguments(args))
    module = _entry_module(script)
    assert module.startswith("points2surf_tpu.cli.")
    swapped = module.replace("points2surf_tpu.", "points2surf_tpu_torch.", 1)
    assert importlib.util.find_spec(swapped) is not None, swapped


def test_defaults_and_device():
    for port, ref in ((train_args, jtrain), (eval_args, jeval)):
        assert vars(port.parse_arguments([])) == vars(ref.parse_arguments([]))
    assert train_args.device_of(train_args.parse_arguments(
        ["--gpu_idx", "2", "3"])) == "cuda:2"
    opt = train_args.parse_arguments(["--train_dtype", "bfloat16"])
    assert opt.train_dtype == "bfloat16"  # accepted; the model build raises
