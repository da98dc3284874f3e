"""Port vs reference: latent (``packed=False``, QAT) serving on the reduced
configs of every family, on the CPU.

Both engines serve the reference's latent params (carried across with the
bridge) with no freeze and no plan: every projection runs the exact int8
pipeline (``core.bitlinear.apply_eval``).  The pair is held by
``_torch_serving.assert_same_run``: equal plans, greedy tokens and
counters, with its near-tie rule unchanged.  Also: a supplied plan warns
and is never consulted, the latent engine's tokens equal the packed
engine's on the same weights, and nothing is frozen.
"""
import numpy as np
import pytest
import torch
from _torch_serving import (assert_same_run, one_torch_thread,  # noqa: F401
                            reference_latent, requests, run_latent_pair)

from repro_torch import bridge
from repro_torch.kernels import tsar_matmul
from repro_torch.serving import Request, ServingEngine

# Tiny reduced-config ops: one torch thread per test worker (see the fixture).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

_KW = dict(max_len=64, batch_slots=2, prefill_chunk=8)
SCENARIOS = {
    # name: (arch, engine kwargs, prompt lengths)
    "dense_flat": ("bitnet-2b-4t", _KW, [3, 8, 21, 40, 5]),
    "dense_chunked": ("bitnet-2b-4t", dict(_KW, policy="chunked"), [3, 8, 21, 40, 5]),
    "moe_flat": ("deepseek-moe-16b", _KW, [3, 8, 21, 40, 5]),
    "ssm_whole": ("mamba2-780m", _KW, [3, 8, 16, 32, 5]),
    "hybrid_whole": ("hymba-1.5b", _KW, [3, 8, 16, 32, 5]),
    "encdec_whole": ("whisper-tiny", _KW, [3, 8, 21, 40, 5]),
    "vlm_whole": ("llava-next-mistral-7b", _KW, [3, 8, 21, 40, 5]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_latent_engine_matches_reference(scenario):
    arch, kw, lens = SCENARIOS[scenario]
    run = run_latent_pair(arch, kw, lambda cls: requests(cls, lens, 5, 7))
    assert_same_run(*run)
    ref, port = run[0], run[1]
    assert port.plan is None and ref.plan is None
    assert port.density is None and "plan_layers" not in port.stats


def _latent(arch):
    cfg, latent = reference_latent(arch)
    import jax

    return cfg, bridge.params_from_reference(jax.tree.map(np.asarray, latent), device="cpu")


def test_latent_serving_freezes_nothing_and_launches_no_kernel(monkeypatch):
    """The engine keeps the latent tree itself, and no projection reaches
    the planes kernel's wrapper; its greedy tokens equal the packed
    engine's on the same weights (the exact int8 pipeline and the planes
    compute the same integer product with the same scales)."""
    cfg, params = _latent("bitnet-2b-4t")
    calls = []
    wrapper = tsar_matmul.tsar_matmul_packed
    monkeypatch.setattr(tsar_matmul, "tsar_matmul_packed",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    latent = ServingEngine(cfg, params, device="cpu", packed=False, **_KW)
    assert latent.params is params
    out = latent.run(requests(Request, [3, 8, 21], 6, 3))
    assert not calls
    packed = ServingEngine(cfg, params, device="cpu", **_KW)
    want = packed.run(requests(Request, [3, 8, 21], 6, 3))
    assert calls
    assert [r.out_tokens for r in out] == [r.out_tokens for r in want]


def test_supplied_plan_warns_with_latent_weights():
    cfg, params = _latent("bitnet-2b-4t")
    base = ServingEngine(cfg, params, device="cpu", **_KW)
    with pytest.warns(UserWarning, match="packed=False"):
        eng = ServingEngine(cfg, params, device="cpu", packed=False, plan=base.plan, **_KW)
    assert eng.plan is base.plan and "plan_matched_layers" not in eng.stats
    out = eng.run(requests(Request, [5], 3, 1))
    assert len(out[0].out_tokens) == 3 and isinstance(out[0].out_tokens[0], int)
    assert torch.equal(eng.params["embed"], params["embed"])


def test_serve_cli_no_packed(capsys):
    """``launch/serve.py --no-packed`` serves the latent weights (no plan)
    with the packed run's tokens; plan flags are refused with it."""
    from repro_torch.launch import serve

    argv = ["--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu", "--requests", "3",
            "--max-new", "3"]
    eng, reqs = serve.main(argv + ["--no-packed"])
    assert eng.plan is None and all(r.done for r in reqs)
    assert "(latent, cpu)" in capsys.readouterr().out
    _, want = serve.main(argv)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]
    with pytest.raises(SystemExit):
        serve.main(argv + ["--no-packed", "--print-plan"])
