"""What a steady measurement of a cell rests on: without a card ``run.py``
exits 2 before it runs the cell, and ``spread.py`` splits a run's window
by step mode, groups runs by seed and reads a set's two spreads."""
import importlib.util
import json
from types import SimpleNamespace

import pytest
import torch

from _benchh100_tiny import tiny_root
from h100bench import cellrun, guard, loadgen, spec

SEED = 2**31 + 4244


@pytest.fixture
def virtual_clock(monkeypatch):
    """Every engine step takes 10 ms of a virtual clock, so a window holds
    the same steps however loaded the CPU is."""
    from repro_torch.serving import engine as eng

    clock = SimpleNamespace(t=0.0)
    clock.perf_counter = lambda: clock.t
    clock.sleep = lambda s: setattr(clock, "t", clock.t + max(0.0, s))
    monkeypatch.setattr(loadgen, "time", clock)
    monkeypatch.setattr(cellrun, "time", clock)
    step = eng.ServingEngine.step

    def timed_step(self):
        clock.t += 0.01
        return step(self)
    monkeypatch.setattr(eng.ServingEngine, "step", timed_step)


def _tiny_run(tmp_path, seconds=0.6):
    name = spec.load_benchmark()["workloads"][0]["name"]
    return cellrun.run(name, SEED, seconds, False, t_start=0.0, root=tiny_root(tmp_path),
                       device="cpu")


def _bench_run():
    path = spec.BENCH_DIR / "run.py"
    mod_spec = importlib.util.spec_from_file_location("h100bench_run", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("card", [True, False])
def test_run_needs_a_card_before_it_runs_the_cell(monkeypatch, capsys, card):
    run = _bench_run()
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(card))
    monkeypatch.setattr(guard, "forbidden", lambda: [])

    def fake_run(name, seed, seconds, trace, *, t_start):
        ran.append(name)
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
                "check": {"max_gap": {"value": 0.0, "limit": 0.1}}, "lateness": {},
                "reference_s": 0.0, "picked": 1}
    monkeypatch.setattr(cellrun, "run", fake_run)
    argv = ["--workload", spec.load_benchmark()["workloads"][0]["name"], "--seed", "1",
            "--seconds", "1"]
    if not card:
        with pytest.raises(SystemExit) as exc:
            run.main(argv)
        assert exc.value.code == 2 and not ran
        assert capsys.readouterr().out == ""
        return
    run.main(argv)
    assert len(ran) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"] is True


def test_spread_splits_the_window_by_step_mode(tmp_path, monkeypatch, virtual_clock):
    import spread

    monkeypatch.setattr(loadgen.Drive, "run", loadgen.Drive.run)   # restored after
    rec = spread.Recorder(loadgen)
    out = _tiny_run(tmp_path, seconds=2.0)
    got = rec.summary(out["metrics"]["itl_p95_ms"]["value"])
    assert got["steps"] > 100 and 0 < got["prompt_share"] < 1
    assert got["decode_p50_ms"] == pytest.approx(10.0)     # one virtual step
    assert got["prompt_p50_ms"] == pytest.approx(10.0)
    assert got["p95_rank_decode"] == got["p95_rank_prompt"] == 1.0   # every step is 10 ms


def test_spreads_by_quartiles_and_by_range_less_the_farthest():
    from spread import quartile_spread, range_spread

    xs = [100.0, 101.0, 99.0, 102.0, 98.0, 130.0]
    assert range_spread(xs) == pytest.approx(4.0 / 100.5)   # 130 left out
    assert quartile_spread(xs) == pytest.approx((109.0 - 98.75) / 100.5)   # exclusive quartiles
    assert range_spread([100.0, 110.0]) == pytest.approx(10.0 / 105.0)


def test_summarize_keeps_a_repeated_seed_apart_from_the_rest():
    from spread import summarize

    rows = [{"checkout": "c", "seed": s, "correct": True, "output_tok_s": x}
            for s, x in [(1, 100.0), (2, 110.0), (1, 102.0), (3, 90.0), (1, 98.0)]]
    got = {r["group"]: r for r in summarize(rows)}
    assert set(got) == {"seed 1 x3", "2 seeds", "all"}
    assert got["seed 1 x3"]["output_tok_s"]["median"] == 100.0
    assert got["2 seeds"]["runs"] == 2 and got["all"]["runs"] == 5
    assert got["all"]["correct"] == 5
