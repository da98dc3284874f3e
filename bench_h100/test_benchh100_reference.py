"""The plain reference against the port's engine, driven by the harness on
the CPU at the port's ``reduced()`` sizes: sound runs agree; the control
(the program's own bfloat16 KV cache, the precision below the float32
that the configurations state) and the faults a serving cell can have come
out not correct."""
import pytest
import torch

from _benchh100_tiny import tiny_root
from h100bench import cellrun, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 4242
SECONDS = 0.6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


class _Clock:
    """The harness's clock in virtual seconds: every engine step takes
    ``STEP_S``, so a window holds the same steps however loaded the CPU is."""
    STEP_S = 0.01

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


@pytest.fixture(autouse=True)
def virtual_clock(monkeypatch):
    from h100bench import loadgen
    from repro_torch.serving import engine as eng

    clock = _Clock()
    monkeypatch.setattr(loadgen, "time", clock)
    monkeypatch.setattr(cellrun, "time", clock)
    step = eng.ServingEngine.step

    def timed_step(self):
        clock.t += clock.STEP_S
        return step(self)
    monkeypatch.setattr(eng.ServingEngine, "step", timed_step)
    return clock


def _run(root, name, **kw):
    return cellrun.run(name, SEED, SECONDS, False, t_start=0.0, root=root,
                       device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_agrees_with_the_reference(root, name):
    out = _run(root, name)
    assert out["correct"], out["check"]
    assert out["check"]["max_gap"]["value"] < 1e-4
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.metrics_for(spec.load_benchmark(root), name, False)}


@pytest.mark.parametrize("name", CELLS)
def test_bf16_cache_control_fails(root, name):
    out = _run(root, name, cache_dtype=torch.bfloat16)
    assert not out["correct"]
    assert out["check"]["max_gap"]["value"] > out["check"]["max_gap"]["limit"]


def _alter_tokens(monkeypatch):
    from repro_torch.serving import engine as eng

    sample = eng.ServingEngine._sample
    monkeypatch.setattr(eng.ServingEngine, "_sample",
                        lambda self, logits, temps: (sample(self, logits, temps) + 1)
                        % self.cfg.vocab_size)


def _state_unchanged(monkeypatch):
    from repro_torch.serving import engine as eng

    monkeypatch.setattr(eng.model_zoo, "scatter_cache_view", lambda pools, writers, view: pools)


def _half_batch(monkeypatch):
    from repro_torch.models import transformer

    embed = transformer._embed

    def half(cfg, params, tokens, patches=None):
        x = embed(cfg, params, tokens, patches)
        x[..., x.shape[-2] // 2:, :] = 0.0
        return x
    monkeypatch.setattr(transformer, "_embed", half)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged, _half_batch])
def test_faults_of_the_timed_path_fail(root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(root, CELLS[0])
    assert not out["correct"], out["check"]


@pytest.mark.gpu
def test_card_sound_run_agrees(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run on the card only")
    out = cellrun.run(CELLS[0], SEED, 2.0, False, t_start=0.0, root=tiny_root(tmp_path),
                      device="cuda")
    assert out["correct"], out["check"]


@pytest.mark.gpu
def test_card_integer_product_is_exact_in_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: TF32 exists on the card only")
    from h100bench import check

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for k, m in ((7168, 19200), (19200, 7168), (2560, 6912)):
        q = torch.randint(-127, 128, (512, k), generator=gen, device="cuda").float()
        t = torch.randint(-1, 2, (k, m), generator=gen, device="cuda").float()
        q[0], t[:, 0] = 127.0, 1.0                      # the largest sum, 127 K
        exact = q.double() @ t.double()
        assert torch.equal(check.reference()._integer_product(q, t).double(), exact)
        assert not torch.backends.cuda.matmul.allow_tf32
