"""The port's three examples (``examples/torch_*.py``) through their
``main()`` with ``--device cpu``, at their own sizes: each runs to its end
and prints the lines its reference counterpart prints."""
import importlib.util
import pathlib

import pytest
from _torch_serving import one_torch_thread  # noqa: F401

from repro_torch.kernels import tally

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(one_torch_thread, capsys):  # noqa: F811
    tallied = len(tally.TALLY)
    out = _load("torch_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("model: bitnet-2b-4t-reduced", "step   0  loss", "step  40  loss",
                 "req 2: [", "decode throughput:"):
        assert line in text, line
    losses = out["losses"]
    assert len(losses) == 60 and sum(losses[-10:]) < sum(losses[:10])
    assert all(len(r.out_tokens) == 12 for r in out["requests"])
    assert len(tally.TALLY) == tallied        # CPU tensors take the plain version


def test_serve_ternary(one_torch_thread, capsys):  # noqa: F811
    out = _load("torch_serve_ternary").main(["--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("execution plan (compiled once at engine init):", "weight density (measured):",
                 "8 requests (prompts 6..54 tok, policy=flat), 128 tokens", "TTFT p50",
                 "TPOT p50", "max step load 20 real tokens (budget 16 + 4 slots)"):
        assert line in text, line
    assert all(r.done and len(r.out_tokens) == 16 for r in out["requests"])
    assert out["engine"].max_step_tokens() <= out["budget"]


def test_train_resume(one_torch_thread, capsys):  # noqa: F811
    report = _load("torch_train_resume").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert report.completed and report.restarts == 1
    assert report.failures == ["RuntimeError('simulated node failure at step 13')"]
    for line in ("[restore] cold start", "[restore] resuming from checkpoint step 12",
                 "step 12 loss", "step 23 loss", "completed=True after 1 restart(s)",
                 "median step time"):
        assert line in text, line


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_ternary",
                                  "torch_train_resume"])
def test_examples_default_to_the_gpu(name):
    """``--device`` defaults to ``cuda``: without a GPU ``main()`` raises
    before it builds anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _load(name).main([])
