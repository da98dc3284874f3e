"""The control of a cell's correctness limit, on several seeds, in one
process.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 [--seconds s]

The control is the program's own lower-precision path: its KV cache in
bfloat16 (``ServingEngine(cache_dtype=torch.bfloat16)``), the precision
below the float32 that the configurations state.  Each seed is a whole run
of the cell (``h100bench.cellrun.run``: weights, warm-up, ramp, window,
drain, reference) at the cell's own size and load; each prints one JSON
line with the numbers its check read.  The benchmark's own runs do not run
this.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()

    import torch

    from h100bench import cellrun, spec

    if not torch.cuda.is_available():
        sys.exit("control.py needs a CUDA device")
    seconds = args.seconds or spec.load_benchmark()["run_seconds"]
    for seed in args.seeds.split(","):
        out = cellrun.run(args.workload, int(seed), seconds, False,
                          t_start=time.perf_counter(), cache_dtype=torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": int(seed), "side": "bf16_kv_cache",
                          "correct": out["correct"], "check": out["check"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "peak_gib": out["device"]["memory_peak_bytes"] / 2**30,
                          "reference_s": out["reference_s"]}), flush=True)


if __name__ == "__main__":
    main()
