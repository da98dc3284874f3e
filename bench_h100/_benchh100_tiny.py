"""Test support: a checkout-shaped directory holding the benchmark's files
with every configuration cut to the port's ``reduced()`` sizes and every
cell to a few slots and short requests, so that whole runs of the harness
fit a CPU test (``h100bench.cellrun.run(..., root=tiny_root(...),
device="cpu")``)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# ``ModelConfig.reduced()``'s sizes.
REDUCED = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
           "vocab_size": 512}
# The reduced models' limit on the widest gap: sound runs read 0.0 and the
# bfloat16-cache control 0.0087-0.069 (bitnet, four seeds, on a CPU); the
# full-size cells' limit is set from their own readings.
MAX_GAP = 0.005


def tiny_root(dest: Path) -> Path:
    dest = Path(dest)
    src = REPO / "bench_h100"
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(src / sub, dest / "bench_h100" / sub)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    bm = json.loads((dest / "BENCHMARK.json").read_text())
    for c in bm["configs"]:
        path = dest / c["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()), **REDUCED}))
    for w in bm["workloads"]:
        path = dest / "bench_h100" / "traffic" / f"{w['traffic']}.json"
        tr = json.loads(path.read_text())
        tr.update(prompt_len={"kind": "uniform", "lo": 16, "hi": 64},
                  output_len={"kind": "uniform", "lo": 16, "hi": 48})
        if tr["loop"] == "closed":
            tr.update(clients=4, requests=4000)
        else:
            tr.update(rate=8.0, prime_s=0.2)
        path.write_text(json.dumps(tr))
        path = dest / "bench_h100" / "cells" / f"{w['name']}.json"
        cell = json.loads(path.read_text())
        cell["engine"].update(slots=4, max_len=128, prefill_chunk=16)
        cell["check"].update(served_tokens=60, max_gap=MAX_GAP)
        path.write_text(json.dumps(cell))
    return dest
