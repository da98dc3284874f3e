"""Fault tolerance and elasticity primitives for long runs (port of
``repro/runtime/fault_tolerance.py``; pure Python, copied, not imported).

* ``run_with_restarts`` -- supervision loop: the train driver's body is a
  function of (state, start_step); on a failure the loop restores the
  latest checkpoint and re-enters.
* ``StepMonitor`` -- per-step wall time with straggler detection (a step
  above ``straggler_factor`` x the rolling median is flagged).
* ``Heartbeat`` -- a liveness file another process can watch; a missed
  deadline means dead.
* ``elastic_remesh_plan`` -- given the devices left, the largest
  (data, model) layout that keeps tensor parallelism intact (shrink data
  parallelism first).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass


class StepMonitor:
    def __init__(self, window: int = 32, straggler_factor: float = 2.5):
        self.times = deque(maxlen=window)
        self.factor = straggler_factor
        self.straggler_steps: list[int] = []
        self._t0 = None
        self._step = 0

    def start(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if self.is_straggler(dt):
            self.straggler_steps.append(self._step)
        self.times.append(dt)
        return dt

    def is_straggler(self, dt: float) -> bool:
        if len(self.times) < 8:
            return False
        med = sorted(self.times)[len(self.times) // 2]
        return dt > self.factor * med

    def median(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": now}, f)
            os.replace(tmp, self.path)
            self._last = now

    @staticmethod
    def is_alive(path: str, deadline_s: float = 60.0) -> bool:
        try:
            with open(path) as f:
                beat = json.load(f)
            return (time.time() - beat["time"]) < deadline_s
        except (OSError, ValueError):
            return False


@dataclass
class RestartReport:
    restarts: int
    completed: bool
    last_step: int
    failures: list


def run_with_restarts(body, *, restore_fn, max_restarts: int = 3) -> RestartReport:
    """Supervision loop.

    ``body(state, start_step) -> final_step`` runs the training segment and
    may raise; ``restore_fn() -> (state, step)`` reloads the latest
    checkpoint.  Used directly by ``launch/train.py`` and by the fault-injection
    tests (which raise at a chosen step to simulate a node loss).
    """
    failures = []
    restarts = 0
    state, step = restore_fn()
    while True:
        try:
            final = body(state, step)
            return RestartReport(restarts, True, final, failures)
        except Exception as e:  # noqa: BLE001 — any worker failure
            failures.append(repr(e))
            restarts += 1
            if restarts > max_restarts:
                return RestartReport(restarts, False, step, failures)
            state, step = restore_fn()


def elastic_remesh_plan(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) mesh on ``n_devices`` keeping TP width intact.

    TP shards hold complementary weight slices — a partial model group is
    useless — so shrink data parallelism first.  Returns (data, model).
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices; "
            "re-plan with smaller model parallelism")
    data = n_devices // model_parallel
    return data, model_parallel
