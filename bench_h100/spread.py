"""Where a cell's run-to-run spread comes from: runs of one cell in turns,
each a process of its own that runs ``run.py``'s ``main`` as the benchmark
does, with the window's steps split by mode.

    python3 bench_h100/spread.py --workload <cell> --runs 7,8,7,9 [--seconds 51] [--out f.jsonl]

A run is ``[checkout@]seed``: a checkout other than this one (an unpacked
parent, say) runs its own ``run.py``.  Runs go in the order given.  Each
prints one JSON line: the result's ``correct``, widest gap and end-to-end
metrics, and

* ``steps``, ``prompt_share``: the window's steps (one step end to the
  next, both in the window) and the share that carry a prompt chunk;
* ``decode_p50_ms`` ... ``prompt_p95_ms``: those steps' times by mode;
* ``p95_rank_decode`` / ``p95_rank_prompt``: the share of each mode's
  steps at or below the run's ``itl_p95_ms``, which says where the 95th
  percentile gap falls between the two modes.

The last lines sum up each checkout's runs, for the runs of a seed that
repeats and for the rest: each metric's median, its quartile spread
((q3 - q1) / median, ``statistics.quantiles``) and its range spread (the
range less the run farthest from the median, over the median), the two
ways ``PERF.md`` §2 reads a set of runs.  It is not part of a benchmark
run and needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
METRICS = ("output_tok_s", "itl_p95_ms", "setup_s", "prompt_share", "decode_p50_ms",
           "decode_p95_ms", "prompt_p50_ms", "prompt_p95_ms")


def quartile_spread(xs: list) -> float | None:
    if len(xs) < 2 or not statistics.median(xs):
        return None
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med


def range_spread(xs: list) -> float | None:
    """The range of ``xs`` over their median, less the value farthest from
    the median where three or more are left."""
    med = statistics.median(xs)
    if len(xs) < 2 or not med:
        return None
    if len(xs) >= 3:
        xs = sorted(xs, key=lambda x: abs(x - med))[:-1]
    return (max(xs) - min(xs)) / med


class Recorder:
    """Hooks ``loadgen.Drive.run``: after every step, the step's end, its
    number and the engine's prompt tokens so far."""

    def __init__(self, loadgen):
        self.marks, self.drive = [], None
        drive_run, rec = loadgen.Drive.run, self

        def run(drive, seconds):
            rec.drive, inner, engine = drive, drive.on_step, drive.engine

            def on_step(d):
                t, step_no = d.step_ends[-1]
                rec.marks.append((t, step_no, engine.stats["prefill_tokens"]))
                if inner is not None:
                    inner(d)
            drive.on_step = on_step
            return drive_run(drive, seconds)
        loadgen.Drive.run = run

    def summary(self, itl_p95_ms: float) -> dict:
        """The window's steps by mode, and where ``itl_p95_ms`` (the run's
        own metric) falls among each mode's step times."""
        t0, t1 = self.drive.t0, self.drive.t1
        steps = [(1e3 * (tb - ta), pb > pa)
                 for (ta, _, pa), (tb, _, pb) in zip(self.marks, self.marks[1:])
                 if t0 <= ta and tb < t1]
        dec = [x for x, p in steps if not p]
        pro = [x for x, p in steps if p]

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else None

        def rank(xs):
            return sum(x <= itl_p95_ms for x in xs) / len(xs) if xs else None
        return {"steps": len(steps), "prompt_share": len(pro) / len(steps) if steps else None,
                "decode_p50_ms": pct(dec, 50), "decode_p95_ms": pct(dec, 95),
                "prompt_p50_ms": pct(pro, 50), "prompt_p95_ms": pct(pro, 95),
                "p95_rank_decode": rank(dec), "p95_rank_prompt": rank(pro)}


def child(checkout: Path, workload: str, seed: int, seconds: float) -> None:
    """One run in this process: the checkout's ``run.py`` ``main`` with the
    recorder on; prints the result's line, then one line ``{"spread": ...}``."""
    import importlib.util

    sys.path[:0] = [str(checkout / "src"), str(checkout / "bench_h100")]
    os.environ.setdefault("USE_FLAX", "0")
    spec = importlib.util.spec_from_file_location("bench_run", checkout / "bench_h100" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from h100bench import loadgen

    rec = Recorder(loadgen)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", "0"])
    result = buf.getvalue().splitlines()[-1]
    print(result, flush=True)
    p95 = json.loads(result)["metrics"]["itl_p95_ms"]["value"]
    print(json.dumps({"spread": rec.summary(p95)}), flush=True)


def one(checkout: Path, workload: str, seed: int, seconds: float, log) -> dict:
    t = time.perf_counter()
    p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(checkout),
                        "--workload", workload, "--runs", str(seed), "--seconds", str(seconds)],
                       cwd=checkout, capture_output=True, text=True, timeout=900)
    row = {"checkout": str(checkout), "seed": seed, "rc": p.returncode,
           "wall_s": time.perf_counter() - t}
    for line in p.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            if "spread" in d:
                row.update(d["spread"])
            elif "correct" in d:
                row.update(correct=d["correct"], gap=d["check"]["max_gap"]["value"],
                           peak_gib=d["device"]["memory_peak_bytes"] / 2**30,
                           **{k: v["value"] for k, v in d["metrics"].items()})
    if p.returncode or "correct" not in row:
        row["stderr"] = p.stderr[-3000:]
    if log is not None:
        log.write(p.stderr)
        log.flush()
    return row


def summarize(rows: list) -> list:
    out = []
    for checkout in dict.fromkeys(r["checkout"] for r in rows):
        mine = [r for r in rows if r["checkout"] == checkout and "correct" in r]
        seeds = [r["seed"] for r in mine]
        groups = {f"seed {s} x{seeds.count(s)}": [r for r in mine if r["seed"] == s]
                  for s in dict.fromkeys(seeds) if seeds.count(s) > 1}
        once = [r for r in mine if seeds.count(r["seed"]) == 1]
        if once:
            groups[f"{len(once)} seeds"] = once
        groups["all"] = mine
        for name, rs in groups.items():
            row = {"checkout": checkout, "group": name, "runs": len(rs),
                   "correct": sum(bool(r["correct"]) for r in rs)}
            for m in METRICS:
                xs = [r[m] for r in rs if r.get(m) is not None]
                if xs:
                    row[m] = {"median": statistics.median(xs), "quartile": quartile_spread(xs),
                              "range": range_spread(xs)}
            out.append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child).resolve(), args.workload, int(args.runs), args.seconds)
        return
    seconds = args.seconds or json.loads((HERE.parent / "BENCHMARK.json").read_text())[
        "run_seconds"]
    out = open(args.out, "w") if args.out else None
    log = open(args.out + ".stderr", "w") if args.out else None
    rows = []
    for spec in args.runs.split(","):
        where, _, seed = spec.rpartition("@")
        row = one(Path(where or HERE.parent).resolve(), args.workload, int(seed), seconds, log)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    for row in summarize(rows):
        line = json.dumps({"summary": row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    for f in (out, log):
        if f:
            f.close()


if __name__ == "__main__":
    main()
