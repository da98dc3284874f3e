"""One run of one benchmark cell of ``repro_torch`` on the GPUs of this
machine.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (it puts ``src`` and ``bench_h100`` on the
path itself).  The last line of standard output is the result: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``, the numbers the
comparison with the plain reference read, each beside its limit; the same
numbers end standard error.  It exits 2, printing no result, without a
CUDA device or with fewer than the cell asks for, outside a checkout that
holds the port, or when a JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def fail(msg: str) -> None:
    print(f"bench_h100: {msg}", file=sys.stderr)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the repository")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from h100bench import cellrun, guard, spec

    bm = spec.load_benchmark()
    chips = spec.workload(bm, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    out = cellrun.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = guard.forbidden()
    if found:
        fail(f"modules that must not be loaded are: {found}")
    print(json.dumps({"lateness": out.pop("lateness"), "reference_s": out.pop("reference_s"),
                      "picked": out.pop("picked")}), flush=True)
    for name, num in out["check"].items():
        print(f"check {name}: {num['value']!r} (limit {num['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    out["check"] = out.pop("check")          # its key comes last
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    main()
