"""Trace-driven serving workloads (port of ``benchmarks/workloads/``):

* ``trace``     — :class:`Trace` / :class:`TraceRequest`, the seeded,
  replayable, canonically serialized request sequence and its fingerprint,
  byte-equal to the reference's;
* ``generator`` — :class:`WorkloadSpec` + :func:`generate`, the arrival
  processes, length distributions, shared-prefix mixes and the seven named
  presets (:data:`WORKLOADS`);
* ``metrics``   — percentile TTFT/TPOT/queue, goodput under per-request
  SLOs, the engine's deterministic counters;
* ``runner``    — :func:`build_engine`, the virtual-time :func:`replay` and
  :func:`run_workload` against the port's ``ServingEngine``.

``launch/serve.py --workload/--trace-file`` serves through them.
"""
from repro_torch.workloads.generator import WORKLOADS, WorkloadSpec, generate, preset
from repro_torch.workloads.runner import build_engine, replay, run_workload
from repro_torch.workloads.trace import Trace, TraceRequest

__all__ = ["WORKLOADS", "Trace", "TraceRequest", "WorkloadSpec", "build_engine",
           "generate", "preset", "replay", "run_workload"]
