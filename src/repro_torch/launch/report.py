"""Render markdown tables from dry-run result JSONs (port of
``repro/launch/report.py``: the same functions and tables, so either
package's report reads either's JSON).

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun_packed.json \
        [build/dryrun_dense.json]
"""
from __future__ import annotations

import json
import sys


def _fmt_bytes(b):
    if b >= 1e9:
        return f"{b/1e9:.2f}GB"
    if b >= 1e6:
        return f"{b/1e6:.1f}MB"
    return f"{b/1e3:.0f}KB"


def dryrun_table(recs, mesh="single") -> str:
    rows = [r for r in recs if r.get("status") == "ok" and r["mesh"] == mesh]
    out = [
        "| arch | shape | mode | chips | flops/dev | HBM bytes/dev | coll bytes/dev | args/dev | temp/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        f = r["roofline"]
        m = r.get("memory_analysis", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('mode','')} | {r['chips']} "
            f"| {f['flops_per_device']:.2e} | {_fmt_bytes(f['bytes_per_device'])} "
            f"| {_fmt_bytes(f['collective_bytes_per_device'])} "
            f"| {_fmt_bytes(m.get('argument_size_in_bytes', 0))} "
            f"| {_fmt_bytes(m.get('temp_size_in_bytes', 0))} |")
    return "\n".join(out)


def roofline_table(recs, mesh="single") -> str:
    rows = [r for r in recs if r.get("status") == "ok" and r["mesh"] == mesh]
    out = [
        "| arch | shape | bound | compute_s | memory_s | collective_s | step_s | useful FLOPs |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        f = r["roofline"]
        step = max(f["compute_s"], f["memory_s"], f["collective_s"])
        useful = min(f["useful_flops_ratio"], 99.99)
        out.append(
            f"| {r['arch']} | {r['shape']} | **{f['bound']}** "
            f"| {f['compute_s']:.3e} | {f['memory_s']:.3e} "
            f"| {f['collective_s']:.3e} | {step:.3e} "
            f"| {100*useful:.0f}% |")
    return "\n".join(out)


def compare_weights(packed, dense) -> str:
    """Serve cells: packed 2-bit vs dense bf16 — the paper's memory claim."""
    key = lambda r: (r["arch"], r["shape"])
    dmap = {key(r): r for r in dense
            if r.get("status") == "ok" and r["mesh"] == "single"}
    out = [
        "| arch | shape | bf16 mem_s | T-SAR mem_s | mem reduction | bf16 step_s | T-SAR step_s | speedup |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in packed:
        if r.get("status") != "ok" or r["mesh"] != "single":
            continue
        if r["shape"] not in ("decode_32k", "long_500k", "prefill_32k"):
            continue
        d = dmap.get(key(r))
        if d is None:
            continue
        fp, fd = r["roofline"], d["roofline"]
        sp = max(fp["compute_s"], fp["memory_s"], fp["collective_s"])
        sd = max(fd["compute_s"], fd["memory_s"], fd["collective_s"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {fd['memory_s']:.3e} "
            f"| {fp['memory_s']:.3e} | {fd['memory_s']/max(fp['memory_s'],1e-12):.2f}x "
            f"| {sd:.3e} | {sp:.3e} | {sd/max(sp,1e-12):.2f}x |")
    return "\n".join(out)


def dedup(recs):
    """Keep the LAST record per (arch, shape, mesh, weights) — re-runs of
    individual cells append to the JSON."""
    out = {}
    for r in recs:
        out[(r["arch"], r["shape"], r["mesh"], r.get("weights", ""))] = r
    return list(out.values())


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun_packed.json"
    with open(path) as f:
        recs = dedup(json.load(f))
    print("## Dry-run (single-pod)\n")
    print(dryrun_table(recs, "single"))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(recs, "single"))
    print("\n## Multi-pod\n")
    print(roofline_table(recs, "multi"))
    if len(sys.argv) > 2:
        with open(sys.argv[2]) as f:
            dense = dedup(json.load(f))
        print("\n## Packed vs dense\n")
        print(compare_weights(recs, dense))


if __name__ == "__main__":
    main()
