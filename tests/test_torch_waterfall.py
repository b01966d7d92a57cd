"""The port's BER waterfall (libpoporon_tpu_torch/benchmarks/waterfall.py)
on the CPU against the JAX package's benchmarks/waterfall.py: for the same
arguments both print the same JSON lines, soft and hard.  The decodes are
bit-exact and every draw comes from the same numpy generator, so the lines
are compared as strings."""

import importlib.util
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu_torch.benchmarks import waterfall  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--batch", "64", "--snrs", "3.0,4.5", "--iters", "10"]


def jax_waterfall():
    spec = importlib.util.spec_from_file_location(
        "jax_waterfall", REPO / "benchmarks" / "waterfall.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--hard"]], ids=["soft", "hard"])
def test_lines_match_jax(extra, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["waterfall.py", *ARGS, *extra])
    jax_waterfall().main()
    want = capsys.readouterr().out.splitlines()
    codec = waterfall.main([*ARGS, *extra, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 2 and got == want
    assert codec.device == torch.device("cpu")


def test_default_device_is_the_card(capsys):
    if torch.cuda.is_available():
        assert waterfall.main(["--batch", "8", "--snrs", "4.0"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            waterfall.main(["--batch", "8", "--snrs", "4.0"])
