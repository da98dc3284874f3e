"""The window's arithmetic: tails over every sample, drained TTFTs in."""
from types import SimpleNamespace

import numpy as np

from h100bench import window


def _tr(due, times, t_admit=None):
    return SimpleNamespace(due=due, times=times, req=SimpleNamespace(t_admit=t_admit))


def test_output_tokens_counts_every_request_in_the_window():
    trs = [_tr(0.0, [0.5, 1.0, 1.5, 10.0]), _tr(-5.0, [0.9, 1.1]), _tr(11.0, [11.5])]
    assert window.output_tokens(trs, 1.0, 10.0) == 3      # 1.0, 1.5, 1.1


def test_itl_takes_gaps_with_both_tokens_in_the_window():
    trs = [_tr(0.0, [0.5, 1.0, 1.5, 2.5, 10.5]), _tr(0.0, [2.0, 2.25])]
    got = sorted(window.itl_samples(trs, 1.0, 10.0))
    assert np.allclose(got, [0.25, 0.5, 1.0])


def test_ttft_includes_drained_requests_and_excludes_others():
    trs = [_tr(1.0, [1.5]),            # in the window
           _tr(9.5, [12.0]),           # due in the window, answered in the drain
           _tr(0.5, [1.2]),            # due before the window (the ramp)
           _tr(10.0, [10.1]),          # due at the close: not in the window
           _tr(2.0, [])]               # never answered: no sample
    assert sorted(window.ttft_samples(trs, 1.0, 10.0)) == [0.5, 2.5]
    assert len(window.due_in_window(trs, 1.0, 10.0)) == 3


def test_tail_over_all_samples_not_chunks():
    xs = list(range(1, 101))
    assert window.percentile(xs, 95) == np.percentile(xs, 95)
    assert window.percentile(xs, 50) == 50.5
    assert window.percentile([], 95) is None


def test_queue_wait_from_the_due_time():
    trs = [_tr(1.0, [3.0], t_admit=2.0), _tr(2.0, [], t_admit=None)]
    assert window.queue_samples(trs, 0.0, 5.0) == [1.0]


def test_profile_slice_reduction():
    from h100bench import profile

    ms = 1_000_000
    events = [("bench.step", False, 0, 100 * ms), ("bench.step", False, 100 * ms, 200 * ms),
              ("tsar_engine_step#3", False, 5 * ms, 95 * ms),
              ("aten::mm", False, 40 * ms, 60 * ms),
              ("tsar_engine_step#3", True, 5 * ms, 95 * ms),      # annotation on the GPU row
              ("void (anonymous namespace)::tsar_matmul_kernel<4>(CUtensorMap)", True, 10 * ms, 30 * ms),
              ("gemm", True, 25 * ms, 40 * ms),
              ("void (anonymous namespace)::tsar_matmul_kernel<4>(CUtensorMap)", True, 120 * ms, 150 * ms)]
    got = profile.read(events)
    assert got["window_s"] == 0.2
    assert abs(got["busy_s"] - 0.06) < 1e-12               # 10-40 and 120-150 ms
    assert abs(got["tsar_s"] - 0.05) < 1e-12
    idle = dict(got["idle_gaps"])
    assert abs(idle["aten::mm"] - 0.08) < 1e-12            # 40-120 ms, opened in aten::mm
    assert abs(idle["host outside every range"] - 0.06) < 1e-12   # 0-10, 150-200 ms
    assert abs(sum(idle.values()) - 0.14) < 1e-12
    assert profile.read([("x", True, 0, 1)]) is None


def test_sweep_calls_a_growing_backlog_unsustained():
    import importlib.util

    from h100bench import spec

    path = spec.BENCH_DIR / "sweep.py"
    mod_spec = importlib.util.spec_from_file_location("h100bench_sweep", path)
    sweep = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(sweep)
    assert sweep.sustained([0, 1, 0, 1, 0, 1, 1, 0, 0])
    assert not sweep.sustained([0, 1, 2, 3, 4, 5, 6, 7, 8])
    assert not sweep.sustained([6, 6, 6, 6, 6, 6])          # never drained
    assert sweep.sustained([])
