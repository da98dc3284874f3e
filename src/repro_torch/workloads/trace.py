"""Replayable request traces (port of ``benchmarks/workloads/trace.py``).

A :class:`Trace` is the unit of reproducibility between the workload
*generator* (``generator.py``) and the engine *replayer* (``runner.py``): a
seeded generator run produces a trace, the trace serializes to canonical
JSON whose bytes are a pure function of (spec, seed), and the runner replays
it against a :class:`~repro_torch.serving.ServingEngine` in virtual time.
The JSON and the SHA-256 ``fingerprint`` of its bytes are the reference's,
byte for byte: a trace made by either package is the same trace.

Arrival times are in **virtual time units**; the replayer maps one engine
step to ``step_dt`` units (default 1.0), so "rate" in the generator specs
reads as *requests per engine step*.  Wall-clock only enters through the
measured per-request latencies, never through the scheduling structure.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field

TRACE_VERSION = 1


@dataclass
class TraceRequest:
    """One request of a workload trace (JSON-serializable)."""
    uid: int
    arrival: float                 # virtual-time units (engine steps)
    prompt: list                   # token IDs (list[int], canonical form)
    max_new_tokens: int
    temperature: float = 0.0
    # Per-request service-level objectives (wall-clock seconds); None = no SLO
    # on that axis.  A request is *good* iff every set SLO is met.
    slo_ttft_s: float | None = None
    slo_tpot_s: float | None = None
    # Shared-prefix bookkeeping: requests with the same non-negative group id
    # share their leading ``prefix_len`` prompt tokens.
    prefix_group: int = -1
    prefix_len: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRequest":
        return cls(**d)


@dataclass
class Trace:
    """A seeded, replayable request sequence plus its provenance."""
    name: str
    seed: int
    spec: dict                     # the generating WorkloadSpec, as a dict
    requests: list = field(default_factory=list)   # list[TraceRequest]
    version: int = TRACE_VERSION

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "name": self.name,
            "seed": self.seed,
            "spec": self.spec,
            "requests": [r.to_dict() for r in self.requests],
        }

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, no whitespace variance — byte-stable
        for a given (spec, seed), which is what the same-seed property test
        and the fingerprint rely on."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        if d.get("version") != TRACE_VERSION:
            raise ValueError(
                f"trace version {d.get('version')!r} != {TRACE_VERSION} "
                "(regenerate the trace with this tree's generator)")
        return cls(name=d["name"], seed=d["seed"], spec=d["spec"],
                   requests=[TraceRequest.from_dict(r) for r in d["requests"]],
                   version=d["version"])

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- identity ------------------------------------------------------------

    def fingerprint(self) -> str:
        """SHA-256 of the canonical JSON bytes (prefixed for greppability)."""
        h = hashlib.sha256(self.to_json().encode("utf-8")).hexdigest()
        return f"sha256:{h}"

    # -- derived -------------------------------------------------------------

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def total_prompt_tokens(self) -> int:
        return sum(len(r.prompt) for r in self.requests)

    def total_output_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.requests)
