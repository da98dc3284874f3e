"""Seeded workload generation (port of ``benchmarks/workloads/generator.py``):
arrival processes x length distributions x shared-prefix mixes, and the
named presets, adversarial ones included (preemption storms, eviction
pressure, decode-heavy tails).

A :class:`WorkloadSpec` is pure data (JSON round-trippable) and
:func:`generate` a pure function ``(spec) -> Trace``: the same
``numpy.random.Generator`` draws in the same order as the reference's, so
the same spec gives a trace byte-identical to the reference generator's
(``tests/test_torch_serve_workload.py``).  A trace's identity is (name,
quick, seed).

Arrival processes (``spec.arrival["kind"]``), rates in requests per engine
step: ``uniform`` (evenly spaced), ``poisson`` (exponential gaps),
``gamma`` (shape ``cv``: below 1 burstier than Poisson), ``burst``
(everything at t=0, closed-loop).  Length distributions (``prompt_len`` /
``output_len``): ``fixed``, ``uniform`` on [lo, hi], ``lognormal`` clipped
to [lo, hi], ``choice`` over ``values`` with optional ``weights``.
Shared-prefix mixes (``shared_prefix``): ``fraction`` of the requests go
round-robin to one of ``groups`` groups sharing their leading
``prefix_len`` tokens; the rest of a prompt is a fresh tail.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.workloads.trace import Trace, TraceRequest

DEFAULT_VOCAB = 256   # matches the reduced() config zoo vocab floor


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative description of one benchmark workload (pure data)."""
    name: str
    n_requests: int
    arrival: dict
    prompt_len: dict
    output_len: dict
    shared_prefix: dict | None = None
    slo: dict = field(default_factory=dict)     # {"ttft_s":, "tpot_s":}
    temperature: float = 0.0
    vocab: int = DEFAULT_VOCAB
    seed: int = 0
    # Engine-construction hints the runner applies (slots, prefill_chunk,
    # block_size, kv_blocks, max_len, prefix_cache).  Part of the spec so an
    # adversarial trace (tight pool, tiny cache capacity) is reproducible
    # from the trace file alone.
    engine: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(**d)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _arrivals(spec_a: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    kind = spec_a.get("kind", "uniform")
    rate = float(spec_a.get("rate", 1.0))
    if kind == "burst":
        return np.zeros(n)
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if kind == "uniform":
        gaps = np.full(n, 1.0 / rate)
    elif kind == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
    elif kind == "gamma":
        cv = float(spec_a.get("cv", 0.25))       # shape; < 1 = bursty
        if cv <= 0:
            raise ValueError(f"gamma cv must be > 0, got {cv}")
        gaps = rng.gamma(shape=cv, scale=1.0 / (rate * cv), size=n)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    t = np.cumsum(gaps)
    return t - t[0]                              # first request arrives at 0


def _lengths(spec_l: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    kind = spec_l.get("kind", "fixed")
    if kind == "fixed":
        out = np.full(n, int(spec_l["value"]))
    elif kind == "uniform":
        out = rng.integers(int(spec_l["lo"]), int(spec_l["hi"]) + 1, size=n)
    elif kind == "lognormal":
        raw = rng.lognormal(float(spec_l["mean"]), float(spec_l["sigma"]),
                            size=n)
        out = np.clip(np.round(raw), int(spec_l.get("lo", 1)),
                      int(spec_l["hi"])).astype(np.int64)
    elif kind == "choice":
        vals = np.asarray(spec_l["values"], np.int64)
        w = spec_l.get("weights")
        p = None if w is None else np.asarray(w, float) / np.sum(w)
        out = rng.choice(vals, size=n, p=p)
    else:
        raise ValueError(f"unknown length kind {kind!r}")
    if (out < 1).any():
        raise ValueError(f"{kind} length spec produced a length < 1")
    return out.astype(np.int64)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def generate(spec: WorkloadSpec) -> Trace:
    """Materialize ``spec`` into a replayable :class:`Trace` (pure, seeded)."""
    n = spec.n_requests
    rng = np.random.default_rng(spec.seed)
    arrivals = _arrivals(spec.arrival, n, rng)
    plens = _lengths(spec.prompt_len, n, rng)
    olens = _lengths(spec.output_len, n, rng)

    # Shared-prefix structure: group prefixes drawn first (so membership
    # changes don't perturb unrelated requests' tokens less than necessary).
    sp = spec.shared_prefix or {}
    groups = int(sp.get("groups", 0))
    prefix_len = int(sp.get("prefix_len", 0))
    fraction = float(sp.get("fraction", 1.0))
    prefixes = [rng.integers(0, spec.vocab, size=prefix_len).tolist()
                for _ in range(groups)]

    slo_ttft = spec.slo.get("ttft_s")
    slo_tpot = spec.slo.get("tpot_s")

    reqs = []
    shared_member = 0
    for i in range(n):
        plen = int(plens[i])
        group = -1
        if groups and prefix_len and rng.random() < fraction:
            group = shared_member % groups
            shared_member += 1
        if group >= 0:
            # At least one fresh tail token: the engine always recomputes the
            # final prompt token, and identical full prompts would measure
            # dedup, not prefix reuse.
            tail = max(1, plen - prefix_len)
            prompt = prefixes[group] + rng.integers(
                0, spec.vocab, size=tail).tolist()
            plen_eff = prefix_len
        else:
            prompt = rng.integers(0, spec.vocab, size=plen).tolist()
            plen_eff = 0
        reqs.append(TraceRequest(
            uid=i, arrival=float(arrivals[i]), prompt=prompt,
            max_new_tokens=int(olens[i]), temperature=spec.temperature,
            slo_ttft_s=slo_ttft, slo_tpot_s=slo_tpot,
            prefix_group=group, prefix_len=plen_eff if group >= 0 else 0))
    return Trace(name=spec.name, seed=spec.seed, spec=spec.to_dict(),
                 requests=reqs)


# ---------------------------------------------------------------------------
# named presets (the workload taxonomy — see docs/benchmarking.md)
# ---------------------------------------------------------------------------

def _scale(n: int, quick: bool) -> int:
    return max(2, n // 2) if quick else n


def preset(name: str, *, quick: bool = False, seed: int = 0) -> WorkloadSpec:
    """Named workload presets.  ``quick`` halves request counts (CI smoke);
    ``seed`` shifts every stream (trace identity is (name, quick, seed))."""
    mk = WorkloadSpec
    if name == "steady":
        # Open-loop Poisson arrivals, mixed prompt lengths: the baseline
        # "realistic traffic" scenario and the headline percentile numbers.
        return mk(
            name=name, n_requests=_scale(12, quick),
            arrival={"kind": "poisson", "rate": 0.5},
            prompt_len={"kind": "lognormal", "mean": 3.0, "sigma": 0.6,
                        "lo": 4, "hi": 96},
            output_len={"kind": "uniform", "lo": 4, "hi": 12},
            slo={"ttft_s": 2.0, "tpot_s": 0.5},
            seed=seed,
            engine={"slots": 4, "prefill_chunk": 16, "max_len": 128})
    if name == "bursty":
        # Gamma arrivals with cv << 1: clumped admissions stress the
        # one-prefill-per-step policy's TTFT tail.
        return mk(
            name=name, n_requests=_scale(12, quick),
            arrival={"kind": "gamma", "rate": 0.8, "cv": 0.15},
            prompt_len={"kind": "uniform", "lo": 8, "hi": 64},
            output_len={"kind": "uniform", "lo": 4, "hi": 10},
            slo={"ttft_s": 3.0, "tpot_s": 0.5},
            seed=seed,
            engine={"slots": 4, "prefill_chunk": 16, "max_len": 128})
    if name == "shared-prefix":
        # System-prompt sharing: ~75%-shared prompts over a few templates;
        # run with the prefix cache ON (the runner replays it cache-off too,
        # asserting token identity — the serving-regression contract).
        return mk(
            name=name, n_requests=_scale(8, quick),
            arrival={"kind": "uniform", "rate": 1.0},
            prompt_len={"kind": "fixed", "value": 64},
            output_len={"kind": "fixed", "value": 8},
            shared_prefix={"groups": 2, "prefix_len": 48, "fraction": 1.0},
            slo={"ttft_s": 2.0, "tpot_s": 0.5},
            seed=seed,
            engine={"slots": 2, "prefill_chunk": 16, "max_len": 128,
                    "prefix_cache": True})
    if name == "decode-heavy":
        # Short prompts, long outputs: steady-state decode cadence (TPOT)
        # dominates; the GEMV regime the T-SAR dataflow optimizes.
        return mk(
            name=name, n_requests=_scale(8, quick),
            arrival={"kind": "poisson", "rate": 1.0},
            prompt_len={"kind": "uniform", "lo": 3, "hi": 10},
            output_len={"kind": "fixed", "value": 12 if quick else 24},
            slo={"ttft_s": 1.0, "tpot_s": 0.5},
            seed=seed,
            engine={"slots": 4, "prefill_chunk": 8, "max_len": 96})
    if name == "preemption-storm":
        # Adversarial: a burst of long prompts into a deliberately tight
        # block pool — recompute-preemption must fire (the runner asserts
        # it) and every request must still complete.
        return mk(
            name=name, n_requests=_scale(6, quick),
            arrival={"kind": "burst"},
            prompt_len={"kind": "uniform", "lo": 24, "hi": 40},
            output_len={"kind": "fixed", "value": 8},
            slo={"ttft_s": 5.0, "tpot_s": 1.0},
            seed=seed,
            engine={"slots": 2, "prefill_chunk": 8, "max_len": 64,
                    "block_size": 4, "kv_blocks": 16,
                    "prefix_cache": True})
    if name == "eviction-pressure":
        # Adversarial: many distinct prefixes through a capacity-capped
        # prefix cache — LRU eviction must fire without stranding
        # admissions (runner asserts evictions > 0).
        return mk(
            name=name, n_requests=_scale(8, quick),
            arrival={"kind": "uniform", "rate": 1.0},
            prompt_len={"kind": "fixed", "value": 24},
            output_len={"kind": "fixed", "value": 4},
            shared_prefix={"groups": 6, "prefix_len": 16, "fraction": 1.0},
            slo={"ttft_s": 10.0, "tpot_s": 2.0},
            seed=seed,
            engine={"slots": 2, "prefill_chunk": 8, "max_len": 64,
                    "block_size": 4, "prefix_cache": 4})
    if name == "mixed":
        # The historical bench_e2e request list, as a trace: mixed prompt
        # lengths, everything queued up front (closed-loop), chunked-vs-
        # whole comparable.
        return mk(
            name=name, n_requests=_scale(8, quick),
            arrival={"kind": "burst"},
            prompt_len={"kind": "choice",
                        "values": [5, 9, 48, 12, 96, 7, 24, 64]},
            output_len={"kind": "fixed", "value": 8 if quick else 16},
            slo={"ttft_s": 5.0, "tpot_s": 1.0},
            seed=seed,
            engine={"slots": 4, "prefill_chunk": 16, "max_len": 256})
    raise ValueError(
        f"unknown workload preset {name!r}; available: {sorted(WORKLOADS)}")


# Preset registry: name -> short description (the taxonomy table in
# docs/benchmarking.md mirrors this).
WORKLOADS = {
    "steady": "Poisson arrivals, lognormal prompts — headline percentiles",
    "bursty": "gamma (cv=0.15) clumped arrivals — TTFT tail stress",
    "shared-prefix": "75%-shared system prompts — prefix-cache reuse",
    "decode-heavy": "short prompts, long outputs — TPOT/decode cadence",
    "preemption-storm": "burst of long prompts, tight KV pool — preemptions",
    "eviction-pressure": "distinct prefixes, capacity-capped cache — LRU",
    "mixed": "legacy mixed-length closed-loop list (chunked-vs-whole)",
}
