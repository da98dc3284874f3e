"""Drive ``ServingEngine.submit``/``step`` on the host clock.

Before every step ``Drive`` submits each request whose due time has
passed, with ``t_submit`` set to that due time; it stamps every emitted
token when ``step()`` returns (``step`` ends in ``torch.cuda.synchronize``);
when the engine is idle it sleeps until the next due time.  A run has three
phases:

1. the ramp, which is set-up: an open loop serves ``prime_s`` seconds of
   its schedule; a closed loop fills every slot and runs until each of its
   first ``clients`` requests has emitted its first token (requests sent in
   the ramp, as the first ones finish, are not waited for);
2. the window of ``seconds``;
3. the drain: no request is sent any more, and the engine steps on until
   every request due in the window has its first token, or ``drain_s``
   seconds (a minute) have passed since the window closed.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

DRAIN_S = 60.0


@dataclass
class Tracked:
    """A request as ``Drive`` sees it."""
    item: object                 # traffic.Item
    req: object                  # the program's Request
    due: float                   # absolute host-clock due time
    submitted: float
    times: list = field(default_factory=list)   # host time of each token
    steps: list = field(default_factory=list)   # engine step number of each token


@dataclass
class Drive:
    engine: object
    make_request: object         # (uid, prompt, max_new, t_submit) -> Request
    items: list
    loop: str                    # "open" | "closed"
    clients: int = 0
    prime_s: float = 0.0
    range: object = None         # name -> context manager (profiler ranges)
    on_step: object = None       # called after every step with the Drive
    drain_s: float = DRAIN_S
    tracked: list = field(default_factory=list)
    step_ends: list = field(default_factory=list)   # (host time, engine step number)
    t0: float | None = None
    t1: float | None = None
    missing: int = 0             # requests due in the window never answered
    _next: int = 0
    _active: list = field(default_factory=list)

    def _range(self, name: str):
        return self.range(name) if self.range else contextlib.nullcontext()

    def _submit(self, item, due: float, now: float) -> None:
        req = self.make_request(item.uid, item.prompt, item.max_new, due)
        self.engine.submit(req)
        tr = Tracked(item=item, req=req, due=due, submitted=now)
        self.tracked.append(tr)
        self._active.append(tr)

    def _take(self) -> object:
        if self._next >= len(self.items):
            raise RuntimeError(f"traffic exhausted after {len(self.items)} requests; "
                               "raise the traffic file's request count")
        item = self.items[self._next]
        self._next += 1
        return item

    def _stamp(self, t: float, step_no: int) -> list:
        """Stamp new tokens; returns the requests that completed."""
        done = []
        for tr in self._active:
            n = len(tr.req.out_tokens)
            while len(tr.times) < n:
                tr.times.append(t)
                tr.steps.append(step_no)
            if tr.req.done:
                done.append(tr)
        for tr in done:
            self._active.remove(tr)
        return done

    def in_window(self, tr) -> bool:
        return self.t0 <= tr.due < self.t1

    def run(self, seconds: float) -> None:
        start = time.perf_counter()
        if self.loop == "open":
            self.t0 = start + self.prime_s
            self.t1 = self.t0 + seconds
        else:
            for _ in range(self.clients):
                self._submit(self._take(), start, start)
        while True:
            now = time.perf_counter()
            draining = self.t1 is not None and now >= self.t1
            if self.loop == "open" and not draining:
                with self._range("bench.submit"):
                    while self._next < len(self.items):
                        due = start + self.items[self._next].due
                        if due > now or due >= self.t1:
                            break
                        self._submit(self._take(), due, now)
            if draining:
                waiting = [tr for tr in self.tracked
                           if self.in_window(tr) and not tr.times]
                if not waiting:
                    return
                if now >= self.t1 + self.drain_s:
                    self.missing = len(waiting)
                    return
            if not self.engine.busy:
                if draining:
                    return
                if self.loop == "closed":
                    raise RuntimeError("a closed loop's engine went idle")
                nxt = self.t1
                if self._next < len(self.items):
                    nxt = min(nxt, start + self.items[self._next].due)
                with self._range("bench.idle"):
                    time.sleep(max(0.0, nxt - time.perf_counter()))
                continue
            with self._range("bench.step"):
                self.engine.step()
            t = time.perf_counter()
            step_no = int(self.engine.stats["steps"]) - 1
            self.step_ends.append((t, step_no))
            with self._range("bench.stamp"):
                done = self._stamp(t, step_no)
                if self.loop == "closed":
                    if self.t0 is None and all(tr.times for tr in self.tracked[:self.clients]):
                        self.t0, self.t1 = t, t + seconds
                    if self.t1 is None or t < self.t1:
                        for _ in done:
                            self._submit(self._take(), t, t)
            if self.on_step is not None:
                self.on_step(self)
