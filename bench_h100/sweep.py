"""The knee of an open-loop cell: the highest offered rate it sustains
without a growing backlog.

    python3 bench_h100/sweep.py --workload <cell> --rates 0.2,0.3,0.4 [--seconds 90] [--seed n]

One process: the cell's weights are made and frozen once; each rate gets a
fresh engine (warmed up as in a run), ``prime_s`` seconds of its schedule,
then a window of ``--seconds``.  The backlog is the number of requests due
and not yet answered (no first token), sampled after every step of the
window; a rate is sustained when the mean backlog over the window's last
third exceeds that over its first third by at most one request and at most
two requests are waiting when the window closes.
Prints one JSON line per rate and a last line with the knee and 4/5 of it.
Needs a CUDA device; it is not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]


def sustained(backlog: list) -> bool:
    if not backlog:
        return True
    third = max(1, len(backlog) // 3)
    early = sum(backlog[:third]) / third
    late = sum(backlog[-third:]) / third
    return late <= early + 1 and backlog[-1] <= 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    from h100bench import cellrun, loadgen, spec, window
    from h100bench import traffic as traffic_lib
    from repro_torch.serving import Request

    if not torch.cuda.is_available():
        sys.exit("sweep.py needs a CUDA device")
    bm = spec.load_benchmark()
    w = spec.workload(bm, args.workload)
    c = spec.config(bm, w["config"])
    cell, tr = spec.cell(args.workload), spec.traffic(w["traffic"])
    if tr["loop"] != "open":
        sys.exit("the knee is an open loop's")
    dev = torch.device("cuda")
    cfg = cellrun.port_config(c)
    params = cellrun.program_params(c, args.seed, dev)
    rows, knee = [], None
    for rate in [float(r) for r in args.rates.split(",")]:
        engine = cellrun.make_engine(cfg, params, cell, tr, dev)
        items = traffic_lib.build({**tr, "rate": rate}, c["vocab_size"], args.seed, args.seconds)
        backlog = []

        def sample(d):
            t = time.perf_counter()
            if d.t0 <= t < d.t1:
                backlog.append(sum(1 for x in d.tracked if x.due <= t and not x.times))
        drive = loadgen.Drive(engine=engine, items=items, loop="open",
                              prime_s=float(tr["prime_s"]), on_step=sample, drain_s=0.0,
                              make_request=lambda uid, p, n, t: Request(
                                  uid=uid, prompt=p, max_new_tokens=n, t_submit=t))
        drive.run(args.seconds)
        t0, t1 = drive.t0, drive.t1
        ttft = window.ttft_samples(drive.tracked, t0, t1)
        third = max(1, len(backlog) // 3)
        row = {"rate": rate, "slots": cell["engine"]["slots"], "sustained": sustained(backlog),
               "due": len(window.due_in_window(drive.tracked, t0, t1)),
               "answered_in_window": sum(1 for x in window.due_in_window(drive.tracked, t0, t1)
                                         if x.times and x.times[0] < t1),
               "backlog_first_third": sum(backlog[:third]) / third,
               "backlog_last_third": sum(backlog[-third:]) / third,
               "backlog_at_close": backlog[-1] if backlog else None,
               "output_tok_s": window.output_tokens(drive.tracked, t0, t1) / args.seconds,
               "ttft_p50_ms": 1e3 * (window.percentile(ttft, 50) or 0),
               "ttft_p95_ms": 1e3 * (window.percentile(ttft, 95) or 0),
               "queue_wait_p95_ms": 1e3 * (window.percentile(
                   window.queue_samples(drive.tracked, t0, t1), 95) or 0),
               "itl_p95_ms": 1e3 * (window.percentile(
                   window.itl_samples(drive.tracked, t0, t1), 95) or 0),
               "steps": len(drive.step_ends), "missing": drive.missing}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if row["sustained"] and (knee is None or rate > knee) and all(
                r["sustained"] for r in rows if r["rate"] < rate):
            knee = rate
        drive.engine = engine = None
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "slots": cell["engine"]["slots"], "knee": knee,
                      "cell_rate": None if knee is None else round(0.8 * knee, 4),
                      "card": torch.cuda.get_device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
