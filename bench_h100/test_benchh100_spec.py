"""The benchmark's files, found by name; the import rule."""
import json
import shutil
import subprocess
import sys

import pytest

from h100bench import guard, spec

BM = spec.load_benchmark()
NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"


def test_every_cell_config_traffic_and_metric_has_its_file():
    for w in BM["workloads"]:
        assert spec.cell(w["name"])["engine"]["policy"] == "flat"
        assert spec.traffic(w["traffic"])["loop"] in ("open", "closed")
        assert spec.config(BM, w["config"])["arch"]
        for trace in (False, True):
            for m in spec.metrics_for(BM, w["name"], trace):
                assert callable(spec.reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BM["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(BM, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_for(BM, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_config_files_hold_the_ports_sizes():
    from h100bench import cellrun
    from repro_torch import configs

    for c in BM["configs"]:
        f = spec.config(BM, c["name"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        port, base = cellrun.port_config(f), configs.get(f["arch"])
        for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                    "vocab_size"):
            assert getattr(port, key) == getattr(base, key), key
        assert (port.rope_theta, port.norm_eps, port.tie_embeddings) == (
            f["rope_theta"], f["rms_norm_eps"], False)
        assert set(f.get("published", {})) <= set(f["reduced"])


def test_discovery_of_files_added_only(tmp_path):
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR / "metrics", root / "bench_h100" / "metrics")
    for sub in ("cells", "traffic", "configs"):
        (root / "bench_h100" / sub).mkdir(parents=True)
    bm = json.loads(json.dumps(BM))
    bm["configs"].append({"name": "new-model", "source": "https://example.org/x",
                          "file": "bench_h100/configs/new-model.json", "reduced": [],
                          "why": "added"})
    bm["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix",
                            "chips": 1, "why": "added"})
    bm["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower",
                            "source": "program_span", "layer": "model step",
                            "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    (root / "bench_h100/configs/new-model.json").write_text(json.dumps({"arch": "x"}))
    (root / "bench_h100/traffic/new-mix.json").write_text(json.dumps({"loop": "open"}))
    (root / "bench_h100/cells/new-cell.json").write_text(json.dumps({"engine": {}}))
    (root / "bench_h100/metrics/new_metric.py").write_text("def read(run):\n    return 7.0\n")
    got = spec.load_benchmark(root)
    assert spec.config(got, "new-model", root) == {"arch": "x"}
    assert spec.traffic("new-mix", root) == {"loop": "open"}
    assert spec.cell("new-cell", root) == {"engine": {}}
    names = [m["name"] for m in spec.metrics_for(got, "new-cell", True)]
    assert "new_metric" in names              # no workloads key: every cell reporting
    assert spec.reader("new_metric", root)(None) == 7.0
    assert spec.reader("new_metric.other-cells", root)(None) == 7.0   # one reader, two names
    assert "step_ms.chat" not in names        # listed for another cell only


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden(["repro_torch", "repro_torch.serving", "jaxtyping"]) == []
    assert guard.forbidden(["repro.models", "jaxlib.xla", "flax", "benchmarks.common",
                            "numpy"]) == ["benchmarks", "flax", "jaxlib", "repro"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', 'bench_h100'];"
            "from h100bench import cellrun, check, guard;"
            "check.reference(); import repro_torch.serving;"
            "print(guard.forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    text = (spec.BENCH_DIR / "reference" / "plain.py").read_text()
    for word in ("repro_torch", "import jax", "from jax", "from repro", "import repro"):
        assert word not in text


@pytest.mark.parametrize("where", ["bare", "cpu"])
def test_run_refuses_without_the_port_or_a_card(tmp_path, where):
    root = spec.ROOT
    if where == "bare":
        shutil.copytree(spec.BENCH_DIR, tmp_path / "bench_h100",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        root = tmp_path
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          BM["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=120)
    if where == "cpu":
        import torch
        if torch.cuda.is_available():
            pytest.skip("this machine has a CUDA device")
    assert out.returncode == 2 and out.stdout == "", out.stderr


def test_benchmark_json_names_and_keys():
    import re

    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BM[k]]
    assert len(names) == len(set(names))
    assert all(re.fullmatch(NAME, n) for n in names)
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BM["per_layer"]}
    assert layers == {"model step", "scheduler", "kernels", "device"}
