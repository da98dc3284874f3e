"""Serving driver: packed 2-bit T-SAR weights, batched requests, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b-4t \
        --requests 8 --max-new 16

``--arch`` takes any config of every family (``bitnet-2b-4t``,
``deepseek-moe-16b``, ``mamba2-780m``, ``hymba-1.5b``, ``whisper-tiny``,
``llava-next-mistral-7b``, ...; the SSM, hybrid, enc-dec and VLM ones run
the ``whole`` policy, the enc-dec encoder on zero frames and the VLM on
zero patches, the reference's stubs).  ``--max-len`` defaults to 128 plus
a VLM's ``frontend_seq`` patch positions.  ``--smoke`` serves the reduced
config; ``--device cpu`` runs the plain PyTorch path on the CPU.  Weights
are random (seed 0): nothing is downloaded.  ``--sparse`` and ``--sparse-block`` set the freeze's padded
block pools; ``--plan-file`` loads an execution plan (the reference's JSON
format) or saves the compiled one there, ``--save-plan`` also writes it,
``--print-plan`` prints the per-layer table, and ``--prefix-cache
[CAPACITY_BLOCKS]`` turns on prefix-caching KV reuse (the value caps the
cached blocks).  ``--no-packed`` serves the latent weights as they are
(QAT serving: the exact int8 pipeline, no freeze, no plan, no kernel).

Observability flags (all composable; the files are the reference's
formats, read by either package's ``obs`` modules):

* ``--trace-out PATH``     — record the run and save a Perfetto
  ``trace_event`` document; analyze with ``python -m
  repro_torch.obs.timeline PATH``.
* ``--trace-stream PATH``  — stream the events to a rotated JSONL file with
  bounded memory (``obs.trace.StreamingSink``); the same CLI reads it.
* ``--profile-steps``      — wrap each engine step's model call in a
  ``tsar_engine_step#<n>`` range and run the serving loop under
  ``torch.profiler``; its Chrome trace goes beside ``--trace-out``
  (``<stem>.torch.json``), which it needs.
* ``--incident-dir DIR``   — arm incident snapshots (SLO breach,
  preemption, rejection, kv pressure, eviction storm); without another
  trace flag a ring-buffer tracer is attached for their recent events.
* ``--metrics-port PORT``  — Prometheus scrape endpoint over the live
  registry on 127.0.0.1 (``/metrics``, ``/metrics.json``; 0 = ephemeral).
* ``--metrics-textfile PATH`` — rewrite a Prometheus textfile every
  ``--metrics-interval`` seconds, and once at the end.

Trace-driven serving (``serve_workload``): ``--workload NAME`` generates a
named workload trace (``repro_torch.workloads.WORKLOADS``: steady, bursty,
shared-prefix, decode-heavy, preemption-storm, eviction-pressure, mixed;
``--smoke`` takes the quick size, ``--seed N`` shifts every stream), and
``--trace-file PATH`` loads a trace JSON where the file exists (replayed
verbatim) or saves the generated one there.  The engine is built from the
trace's engine hints, the trace is replayed in virtual time
(``workloads.runner.replay``), and the run prints the trace's fingerprint,
TTFT / TPOT percentiles, goodput under the trace's SLOs and the
deterministic counters, as the reference's ``serve.py`` does; the traces
are byte-equal to the reference generator's.  The observability flags
compose with it:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b-4t \
        --smoke --device cpu --workload preemption-storm --seed 0 \
        [--trace-file /tmp/storm.json]
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.obs import export as obs_export
from repro_torch.obs.incident import IncidentMonitor
from repro_torch.obs.trace import (STEP_RANGE, EventTracer, MemorySink, RingSink,
                                   StreamingSink, TeeSink)
from repro_torch.plan import ModelPlan, format_plan
from repro_torch.serving import Request, ServingEngine, freeze_params
from repro_torch.workloads import generator, metrics, runner
from repro_torch.workloads.trace import Trace

_SPARSE = {"auto": "auto", "true": True, "false": False}


def _print_percentiles(engine) -> None:
    pct = engine.latency_percentiles()
    t, p = pct["ttft_s"], pct["tpot_s"]
    print(f"TTFT p50/p90/p99 {t['p50'] * 1e3:.0f}/{t['p90'] * 1e3:.0f}/"
          f"{t['p99'] * 1e3:.0f}ms | TPOT p50/p99 {p['p50'] * 1e3:.2f}/"
          f"{p['p99'] * 1e3:.2f}ms | "
          f"queue p99 {pct['queue_s']['p99'] * 1e3:.0f}ms | "
          f"policy={engine.policy}")


def _save_trace(tracer, path: str) -> None:
    doc = tracer.save(path)
    print(f"obs trace: {path} ({len(doc['traceEvents'])} events, "
          f"{doc['otherData']['fingerprint'][:23]}…) — analyze with "
          f"python -m repro_torch.obs.timeline {path}", file=sys.stderr)


def _obs_setup(args) -> dict:
    """Build the tracer (sinks as the flags compose them) and the incident
    monitor; returns the state the start and finish helpers pass on."""
    sinks, stream = [], None
    if args.trace_out:
        sinks.append(MemorySink())
    if args.trace_stream:
        stream = StreamingSink(args.trace_stream)
        sinks.append(stream)
    if not sinks and args.incident_dir:
        # Flight recorder: incidents need some recent-event source, and a
        # ring is cheap enough to attach implicitly.
        sinks.append(RingSink())
    tracer = None
    if sinks:
        tracer = EventTracer(sink=sinks[0] if len(sinks) == 1 else TeeSink(*sinks))
    monitor = IncidentMonitor(args.incident_dir) if args.incident_dir else None
    return {"tracer": tracer, "stream": stream, "monitor": monitor,
            "server": None, "textfile": None}


def _obs_start(args, engine, obs: dict) -> None:
    """Bring up the export surface once the engine (and its registry)
    exists."""
    if args.metrics_port is not None:
        obs["server"] = obs_export.start_server(engine.metrics, port=args.metrics_port)
        print(f"metrics: scrape endpoint at {obs['server'].url} "
              f"(and /metrics.json)", file=sys.stderr)
    if args.metrics_textfile:
        obs["textfile"] = obs_export.TextfileWriter(
            engine.metrics, args.metrics_textfile,
            interval_s=args.metrics_interval).start()


def _obs_finish(args, obs: dict) -> None:
    """Flush and close every telemetry surface at the end of a run."""
    if obs["textfile"] is not None:
        obs["textfile"].stop()
        print(f"metrics: textfile {args.metrics_textfile} "
              f"({obs['textfile'].n_writes} writes)", file=sys.stderr)
    if obs["server"] is not None:
        obs["server"].stop()
    if obs["tracer"] is not None and args.trace_out:
        _save_trace(obs["tracer"], args.trace_out)
    if obs["stream"] is not None:
        info = obs["stream"].finalize()
        print(f"obs stream: {info['path']} ({info['n_events']} events, "
              f"{info['segments']} segment(s), "
              f"{info['fingerprint'][:23]}…) — analyze with "
              f"python -m repro_torch.obs.timeline {info['path']}", file=sys.stderr)
    mon = obs["monitor"]
    if mon is not None:
        s = mon.summary()
        if s["n"]:
            by = ", ".join(f"{k}: {v}" for k, v in sorted(s["by_trigger"].items()))
            print(f"incidents: {s['n']} snapshot(s) in {args.incident_dir} "
                  f"({by}; {s['suppressed']} debounced)", file=sys.stderr)
        else:
            print(f"incidents: none fired ({s['suppressed']} debounced)",
                  file=sys.stderr)



def _model(args, dev) -> tuple:
    """(config, params) as the flags ask: random weights from a generator
    seeded 0 on ``dev``, frozen unless ``--no-packed`` (before the engine,
    so the latent float32 weights can be dropped)."""
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if not args.no_packed:
        block = (args.sparse_block[0], args.sparse_block[-1]) if args.sparse_block else None
        params = freeze_params(params, sparse=_SPARSE[args.sparse], block_shape=block)
    return cfg, params


def _profiled(args, engine, serve):
    """``serve()``, under ``torch.profiler`` with ``--profile-steps`` (host
    ops, and the card's kernels on a CUDA device; the Chrome trace goes
    beside ``--trace-out``); returns what ``serve`` returns."""
    if not args.profile_steps:
        return serve()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if engine.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out = serve()
    path = Path(args.trace_out)
    path = str(path.with_name(path.stem + ".torch.json"))
    prof.export_chrome_trace(path)
    n = sum(e.name.startswith(STEP_RANGE) for e in prof.events())
    print(f"torch.profiler: {path} ({n} {STEP_RANGE} ranges over "
          f"{engine.stats['steps']} steps)", file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache positions per slot (default 128, plus a VLM's patches)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-packed", action="store_true",
                    help="serve the latent weights: no freeze, no plan, no kernel")
    ap.add_argument("--sparse", choices=sorted(_SPARSE), default="auto",
                    help="padded block-sparse pools: where blocks die (auto), "
                         "always (true) or never (false)")
    ap.add_argument("--sparse-block", type=int, nargs="+", default=None,
                    metavar="B", help="pool block shape: BK [BM] (default 256 256)")
    ap.add_argument("--plan-file", default=None, metavar="PATH",
                    help="execution-plan JSON: loaded if it exists, otherwise "
                         "the compiled plan is saved there")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="also write the engine's plan JSON here after init")
    ap.add_argument("--print-plan", action="store_true",
                    help="print the per-layer, per-bucket plan table")
    ap.add_argument("--prefix-cache", nargs="?", const=True, default=False,
                    type=int, metavar="CAPACITY_BLOCKS",
                    help="enable prefix-caching KV reuse; optional value "
                         "caps the cached-block footprint (LRU-evicted)")
    ap.add_argument("--workload", default=None, metavar="NAME",
                    help="serve a generated workload trace instead of the "
                         "built-in request list (repro_torch.workloads.WORKLOADS) "
                         "and report percentile TTFT/TPOT + goodput under the "
                         "trace's SLOs")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="workload trace JSON: loaded if it exists (replayed "
                         "verbatim), otherwise the trace generated by --workload "
                         "is saved there")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload generation seed (with --workload)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the run and save a Perfetto trace_event JSON "
                         "document (python -m repro_torch.obs.timeline PATH)")
    ap.add_argument("--profile-steps", action="store_true",
                    help="mark each engine step as a torch.profiler range, run "
                         "under torch.profiler and write its Chrome trace beside "
                         "--trace-out (<stem>.torch.json)")
    ap.add_argument("--trace-stream", default=None, metavar="PATH",
                    help="stream trace events to a rotated JSONL file (bounded "
                         "memory; OBS_TRACE_STREAM schema v1); the same timeline "
                         "CLI analyzes it")
    ap.add_argument("--incident-dir", default=None, metavar="DIR",
                    help="write incident snapshots (ring buffer + metrics "
                         "snapshot) here when SLO/preemption/rejection/"
                         "kv-pressure/eviction-storm triggers fire")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text exposition at "
                         "http://127.0.0.1:PORT/metrics (0 = ephemeral)")
    ap.add_argument("--metrics-textfile", default=None, metavar="PATH",
                    help="periodically rewrite a Prometheus textfile "
                         "(atomic replace) for scrape-less environments")
    ap.add_argument("--metrics-interval", type=float, default=5.0, metavar="SECONDS",
                    help="rewrite interval for --metrics-textfile")
    args = ap.parse_args(argv)
    if args.no_packed and (args.plan_file or args.save_plan or args.print_plan):
        ap.error("--no-packed serves without an execution plan")
    if args.profile_steps and not args.trace_out:
        ap.error("--profile-steps writes its trace beside --trace-out")

    if args.workload or args.trace_file:
        return serve_workload(args)

    dev = resolve_device(args.device)
    cfg, params = _model(args, dev)
    plan = None
    if args.plan_file and os.path.exists(args.plan_file):
        plan = ModelPlan.load(args.plan_file)
        print(f"plan: loaded {args.plan_file} ({len(plan.layers)} layers, "
              f"buckets {list(plan.buckets)})")
    max_len = args.max_len or 128 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    obs = _obs_setup(args)
    engine = ServingEngine(cfg, params, max_len=max_len,
                           batch_slots=args.slots, plan=plan, packed=not args.no_packed,
                           prefix_cache=args.prefix_cache, tracer=obs["tracer"],
                           incidents=obs["monitor"], profiler_annotations=args.profile_steps,
                           device=dev)
    _obs_start(args, engine, obs)
    if plan is None and args.plan_file:
        engine.plan.save(args.plan_file)
        print(f"plan: compiled and saved to {args.plan_file}")
    if args.save_plan:
        engine.plan.save(args.save_plan)
    if engine.plan is not None:
        s = engine.plan.summary()
        print(f"plan: {s['layers']} layers | decode -> {s['decode_kernel']} | "
              f"prefill -> {s['prefill_kernel']}")
    if args.print_plan:
        print(format_plan(engine.plan))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=4 + i % 8),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    _profiled(args, engine, lambda: engine.run(reqs))
    for r in reqs[:4]:
        print(f"req {r.uid}: {r.out_tokens}")
    print(f"prefill {engine.stats['prefill_s']:.2f}s | "
          f"decode {engine.stats['decode_s']:.2f}s | "
          f"{engine.throughput():.1f} tok/s steady-state "
          f"({'latent' if args.no_packed else 'packed 2-bit'}, {dev}) | "
          f"steps {engine.stats['steps']}")
    _print_percentiles(engine)
    if engine.prefix is not None:
        print(f"prefix cache: hit rate {engine.stats['prefix_hit_rate']:.2f} | "
              f"{engine.stats['cached_blocks']} cached blocks | "
              f"{engine.stats['prefix_evictions']} evictions")
    _obs_finish(args, obs)
    return engine, reqs


def serve_workload(args):
    """Trace-driven serving: generate (or load) a workload trace, replay it
    in virtual time on an engine built from its hints, and report
    percentile latencies, goodput and the deterministic counters.  Returns
    (engine, requests in trace order)."""
    if args.trace_file and os.path.exists(args.trace_file):
        trace = Trace.load(args.trace_file)
        spec = generator.WorkloadSpec.from_dict(trace.spec)
        print(f"trace: loaded {args.trace_file} ({trace.n_requests} requests,"
              f" workload {trace.name!r}, {trace.fingerprint()[:18]}…)")
    else:
        if not args.workload:
            raise SystemExit("--trace-file points at a missing file and no "
                             "--workload was given to generate one")
        spec = generator.preset(args.workload, quick=args.smoke, seed=args.seed)
        trace = generator.generate(spec)
        print(f"trace: generated workload {spec.name!r} "
              f"({trace.n_requests} requests, seed {args.seed}, "
              f"{trace.fingerprint()[:18]}…)")
        if args.trace_file:
            trace.save(args.trace_file)
            print(f"trace: saved to {args.trace_file}")

    dev = resolve_device(args.device)
    cfg, params = _model(args, dev)
    obs = _obs_setup(args)
    engine = runner.build_engine(spec, cfg, params, packed=not args.no_packed,
                                 tracer=obs["tracer"], incidents=obs["monitor"],
                                 device=dev, profiler_annotations=args.profile_steps)
    _obs_start(args, engine, obs)
    reqs, wall = _profiled(args, engine, lambda: runner.replay(engine, trace))
    m = metrics.latency_metrics(reqs, trace, wall)
    c = metrics.engine_counters(engine)
    t, p, g = m["ttft_s"], m["tpot_s"], m["goodput"]
    print(f"TTFT p50/p90/p99 {t['p50'] * 1e3:.0f}/{t['p90'] * 1e3:.0f}/"
          f"{t['p99'] * 1e3:.0f}ms | TPOT p50/p99 {p['p50'] * 1e3:.2f}/"
          f"{p['p99'] * 1e3:.2f}ms")
    print(f"goodput {g['good']}/{g['total']} ({g['slo_attained']:.0%}) "
          f"under SLO | {m['output_tok_s']:.1f} out tok/s | "
          f"wall {m['wall_s']:.2f}s")
    print(f"counters: steps={c['steps']} preemptions={c['preemptions']} "
          f"prefill_tokens={c['prefill_tokens']} "
          f"prefix_hit_rate={c.get('prefix_hit_rate', 0.0):.3f} "
          f"plan_kernel={c['plan_kernel']}")
    _obs_finish(args, obs)
    return engine, reqs


if __name__ == "__main__":
    main()
