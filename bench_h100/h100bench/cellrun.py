"""One run of one cell: set-up, the window, the drain, the metrics, the
check.  ``bench_h100/run.py`` is its command line; the knee sweep and the
control call it too.

Set-up (``setup_s``, from the process's start to the window's start): the
cell's files; the latent weights made on the device one layer at a time
and handed to the port's ``freeze_params`` layer by layer
(``models.transformer.stack_layers`` stacks them); the engine; its
``warmup`` at the cell's longest request, which builds and loads every
kernel and runs every step shape the traffic uses; the traffic's ramp.
Then the window, the drain, ``memory_peak_bytes``, and, with the program's
state freed, the reference check.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from dataclasses import dataclass

from h100bench import check, loadgen, profile, roofline, spec, weights, window
from h100bench import traffic as traffic_lib

ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")


def log(t_start: float, msg: str) -> None:
    print(f"[{time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def port_config(c: dict):
    """The port's ``ModelConfig`` of a configuration file: its ``arch``
    with the file's sizes, RoPE base and norm epsilon.  Refuses what the
    plain reference does not compute."""
    from repro_torch import configs

    base = configs.get(c["arch"])
    if (base.family != "dense" or not base.mlp_gated or base.qk_norm or base.window_pattern
            or base.attn_softcap or base.logit_softcap or c["hidden_act"] != "silu"
            or c["tie_word_embeddings"] or c.get("rope_scaling")):
        raise ValueError(f"{c['arch']}: the benchmark's reference computes dense, untied "
                         "SwiGLU decoders with full, unscaled RoPE attention only")
    n = weights.dims(c)
    return dataclasses.replace(
        base, n_layers=n["layers"], d_model=n["d"], n_heads=n["h"], n_kv_heads=n["hk"],
        d_head=n["dh"], d_ff=n["f"], vocab_size=n["vocab"], rope_theta=n["theta"],
        norm_eps=n["eps"])


def program_params(c: dict, seed: int, device) -> dict:
    """The cell's weights in the port's layout, frozen one layer at a
    time."""
    from repro_torch.models.transformer import stack_layers
    from repro_torch.serving import freeze_params

    blocks = []
    for i in range(weights.dims(c)["layers"]):
        w = weights.layer(c, seed, i, device)
        latent = {"ln1": {"g": w.pop("ln1").clone()},
                  "attn": {k: {"w": w[k]} for k in ATTN},
                  "ln2": {"g": w.pop("ln2").clone()},
                  "mlp": {k: {"w": w[k]} for k in MLP}}
        del w
        blocks.append(freeze_params(latent))
        del latent
    hw = weights.head(c, seed, device)
    return {"blocks": stack_layers(blocks), "embed": hw["embed"],
            "ln_f": {"g": hw["ln_f"]}, "lm_head": {"wd": hw["lm_head"]}}


def make_engine(cfg, params, cell: dict, tr_spec: dict, dev, *, tracer=None,
                cache_dtype=None):
    """The cell's ``ServingEngine``, warmed up at its longest request: the
    first call of every kernel builds and loads it, and every step shape of
    the traffic (the chunk-carrying and the pure-decode widths, every view
    length up to the longest request) runs once."""
    import torch

    from repro_torch.serving import ServingEngine

    e = cell["engine"]
    engine = ServingEngine(cfg, params, max_len=e["max_len"], batch_slots=e["slots"],
                           prefill_chunk=e["prefill_chunk"], block_size=e["block_size"],
                           policy=e["policy"], tracer=tracer,
                           profiler_annotations=tracer is not None,
                           cache_dtype=cache_dtype or torch.float32, device=dev)
    engine.warmup(seq_len=min(traffic_lib.longest(tr_spec), e["max_len"] - 1))
    return engine


def counters(engine) -> dict:
    """The engine's numeric ``stats`` and the registry counters the stats
    leave out, by name."""
    m = engine.metrics
    out = {k: v for k, v in ((k, engine.stats[k]) for k in engine.stats)
           if isinstance(v, (int, float))}
    out.update(prefill_steps=m.get("prefill_steps").value,
               realized=m.get("realized_tokens").value,
               planned=m.get("planned_tokens").value)
    return out


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a if k in b}


@dataclass
class Run:
    """What a metric's reader reads: the cell's files, the ``Drive`` (every
    request with its token stamps, the step ends), the engine (still alive
    while the readers run), the window's and the profiled slice's counter
    deltas, and in a traced run the stopped profiler of the slice, the
    tracer's events, the slice's reduction, the window's model FLOPs and the
    slice's least projection time."""
    cfg: dict
    cell: dict
    traffic: dict
    seconds: float
    drive: loadgen.Drive
    engine: object
    setup_s: float
    counters: dict                      # the window's engine counters
    slice_counters: dict | None = None  # those of the profiled slice
    prof: object = None                 # the slice's torch.profiler.profile
    events: list | None = None          # the tracer's events
    slice: dict | None = None           # profile.read of the slice
    flops: float | None = None          # model FLOPs of the window
    slice_bound_s: float | None = None  # least time of the slice's projections

    @property
    def t0(self) -> float:
        return self.drive.t0

    @property
    def t1(self) -> float:
        return self.drive.t1


class _Watch:
    """Per-step hook: counter snapshots at the window's edges and, in a
    traced run, the profiled slice."""

    def __init__(self, engine, seconds: float, prof=None, offset: float = 0.0,
                 steps: int = 0):
        self.engine, self.seconds, self.prof = engine, seconds, prof
        self.offset, self.steps = offset, steps
        self.at0 = self.at1 = self.s0 = self.s1 = None
        self.first = self.last = None

    def __call__(self, drive) -> None:
        t = time.perf_counter()
        if drive.t0 is None or t < drive.t0:
            return
        if self.at0 is None:
            self.at0 = counters(self.engine)
        if self.at1 is None and t >= drive.t1:
            self.at1 = counters(self.engine)
        if self.prof is None or self.s1 is not None:
            return
        if self.s0 is None:
            if t >= drive.t0 + self.offset * self.seconds and t < drive.t1:
                self.s0 = counters(self.engine)
                self.first = self.s0["steps"]
                self.prof.start()
        elif counters(self.engine)["steps"] - self.first >= self.steps:
            self.prof.stop()
            self.s1 = counters(self.engine)
            self.last = self.s1["steps"] - 1


def _flops(c: dict, drive, events: list) -> float:
    """Model FLOPs of the steps that ended in the window: prefill rows and
    their contexts from the tracer's ``prefill_chunk`` marks, decode rows
    from the tokens stamped per step."""
    rows, ctx, emitted = {}, {}, {}
    step = None
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "step":
            step = ev["args"]["step"]
        elif ev.get("ph") == "n" and ev.get("name") == "prefill_chunk":
            n, s = ev["args"]["n"], ev["args"]["start"]
            rows[step] = rows.get(step, 0) + n
            ctx[step] = ctx.get(step, 0) + n * s + n * (n + 1) // 2
    for tr in drive.tracked:
        plen = len(tr.item.prompt)
        for j, st in enumerate(tr.steps):
            emitted[st] = emitted.get(st, 0) + 1
            if j:
                rows[st] = rows.get(st, 0) + 1
                ctx[st] = ctx.get(st, 0) + plen + j
    inside = {st for t, st in drive.step_ends if drive.t0 <= t < drive.t1}
    return sum(roofline.flops(c, rows.get(s, 0), ctx.get(s, 0), emitted.get(s, 0))
               for s in inside)


def _slice_bound(c: dict, events: list, first: int, last: int) -> float:
    return sum(roofline.step_bound_s(c, ev["args"]["planned"]) for ev in events
               if ev.get("ph") == "X" and ev.get("name") == "step"
               and first <= ev["args"]["step"] <= last)


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root=spec.ROOT, device="cuda", cache_dtype=None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``check``) and
    ``lateness``."""
    import torch

    from repro_torch.obs import EventTracer
    from repro_torch.serving import Request

    bm = spec.load_benchmark(root)
    w = spec.workload(bm, name)
    c = spec.config(bm, w["config"], root)
    cell = spec.cell(name, root)
    tr_spec = spec.traffic(w["traffic"], root)
    specs = spec.metrics_for(bm, name, trace)
    readers = {m["name"]: spec.reader(m["name"], root) for m in specs}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    cfg = port_config(c)
    log(t_start, f"{name}: seed {seed}, {seconds} s, trace {int(trace)}")
    params = program_params(c, seed, dev)
    log(t_start, f"weights made and frozen ({w['config']})")
    tracer = EventTracer() if trace else None
    engine = make_engine(cfg, params, cell, tr_spec, dev, tracer=tracer,
                         cache_dtype=cache_dtype)
    del params
    log(t_start, "engine built and warmed up; peak so far "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0:.2f} GiB")
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):      # initialise the profiler
            torch.zeros(1, device=dev).add_(1)
        prof = torch.profiler.profile(activities=acts)
    items = traffic_lib.build(tr_spec, c["vocab_size"], seed, seconds)
    tc = cell.get("trace", {})
    watch = _Watch(engine, seconds, prof, tc.get("offset", 0.3), tc.get("steps", 8))
    drive = loadgen.Drive(
        engine=engine, items=items, loop=tr_spec["loop"],
        clients=int(tr_spec.get("clients", 0)), prime_s=float(tr_spec.get("prime_s", 0.0)),
        make_request=lambda uid, p, n, t: Request(uid=uid, prompt=p, max_new_tokens=n,
                                                  t_submit=t),
        range=torch.profiler.record_function if trace else None, on_step=watch)
    drive.run(seconds)
    log(t_start, f"window opened at {drive.t0 - t_start:.2f} s; drained "
        f"{time.perf_counter() - drive.t1:.2f} s after it closed; "
        f"{len(drive.tracked)} requests sent, {len(drive.step_ends)} steps")
    if watch.at1 is None:
        watch.at1 = counters(engine)
    setup_s = drive.t0 - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    r = Run(cfg=c, cell=cell, traffic=tr_spec, seconds=seconds, drive=drive, engine=engine,
            setup_s=setup_s, counters=delta(watch.at0, watch.at1))
    if trace:
        r.events = tracer.events
        if watch.s1 is not None:
            r.prof = prof
            r.slice_counters = delta(watch.s0, watch.s1)
            r.slice = profile.read(profile.kineto_events(prof))
            r.slice_bound_s = _slice_bound(c, tracer.events, watch.first, watch.last)
        elif watch.s0 is not None:
            prof.stop()
        r.flops = _flops(c, drive, tracer.events)
    metrics = {}
    for m in specs:
        v = readers[m["name"]](r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    finished = [t for t in drive.tracked if t.req.done and t.req.out_tokens]
    due = window.due_in_window(drive.tracked, drive.t0, drive.t1)
    late = [t.submitted - t.due for t in due]
    rejected = r.counters["rejections"]
    missing = drive.missing
    # Free the program's state before the reference runs.
    drive.engine = watch.engine = r.engine = engine = tracer = None
    watch.prof = r.prof = prof = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ck = cell["check"]
    picked = check.sample(finished, int(ck["served_tokens"]), seed)
    t_ref = time.perf_counter()
    widest, compared = check.gaps(c, seed, picked, dev) if picked else (None, 0)
    ref_s = time.perf_counter() - t_ref
    log(t_start, f"reference over {len(picked)} requests, {compared} served tokens: "
        f"{ref_s:.2f} s")
    numbers = {"max_gap": {"value": widest, "limit": float(ck["max_gap"])},
               "served_compared": {"value": compared, "limit": 1},
               "unanswered": {"value": missing + int(rejected), "limit": 0}}
    correct = (compared >= 1 and widest <= ck["max_gap"] and missing + rejected == 0)
    device_info = {"platform": "gpu" if cuda else dev.type, "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(due),
           "failed": int(missing + rejected), "metrics": metrics, "device": device_info,
           "check": numbers,
           "lateness": {"p50_ms": 1e3 * window.percentile(late, 50) if late else None,
                        "max_ms": 1e3 * max(late) if late else None, "n": len(late)},
           "reference_s": ref_s, "picked": len(picked)}
    if trace and r.slice is not None:
        device_info["busy_s"] = r.slice["busy_s"]
        device_info["window_s"] = r.slice["window_s"]
        out["breakdown"] = {"device_ops": r.slice["device_ops"],
                            "idle_gaps": r.slice["idle_gaps"]}
    return out
