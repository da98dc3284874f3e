"""Low-overhead structured event tracing for the serving engine, exported
as Chrome/Perfetto ``trace_event`` JSON.  A copy of the reference's
``repro/obs/trace.py`` with the same on-disk formats (``OBS_TRACE`` v1,
``OBS_TRACE_STREAM`` v1), so each package reads and validates the other's
files; what differs: :func:`span` and :func:`step_annotation` (``torch.profiler``
ranges inside the program) and the tracer's clock anchor (``unix_ns``).

Two recorders share one interface:

* :data:`NULL_TRACER` — the default.  ``enabled`` is False and every method
  is a no-op; emit sites in the engine guard on ``tracer.enabled`` before
  building argument dicts, so a tracing-off engine pays one attribute read
  per potential event (tested: step counters are bit-identical to an
  untraced engine).
* :class:`EventTracer` — emits events into a pluggable **sink**,
  timestamped from ``time.perf_counter`` relative to the tracer epoch, in
  microseconds (the ``trace_event`` clock unit).

Sinks decide what "record an event" means; the tracer never knows which
one it feeds:

* :class:`MemorySink` — the default: an in-memory list, exported whole via
  ``save()``/``to_perfetto()``.
* :class:`StreamingSink` — bounded-memory JSONL append to disk with
  size-based segment rotation, for runs far longer than RAM.  It maintains
  the structure fingerprint *incrementally* so the finalized stream
  fingerprints **byte-for-byte identically** to a ``MemorySink`` export of
  the same event sequence (see the stream format section below).
* :class:`RingSink` — fixed-capacity flight recorder (a ``deque``): cheap
  enough to leave always-on so incident snapshots
  (``repro_torch.obs.incident``) can dump the last N events post-hoc.
* :class:`TeeSink` — fan-out to several sinks (e.g. memory + streaming,
  which is how a run checks fingerprint identity between the two paths).

Event taxonomy (see docs/observability.md for the full contract):

* **request lifecycle** — async spans keyed by request uid (Perfetto
  groups async events by ``(cat, id)``, so each request renders as its own
  track): a ``req`` envelope span containing ``queued`` / ``prefill`` /
  ``decode`` sub-spans, with instants ``admitted`` (args: slot, cached_len,
  readmission), ``prefill_chunk``, ``prefix_hit``, ``first_token``,
  ``preempted``, ``finished``, ``cancelled``.  A preempted request closes
  its open phase span with ``preempted: true`` and re-opens ``queued`` —
  the span sequence is well-formed by construction (property-tested).
* **engine steps** — one complete (``X``) event per step on the dedicated
  engine thread, args carrying the deterministic step record: planned vs
  realized token budget, prefill/decode split, KV blocks in use, active
  slots, the plan kernel serving this step's row bucket.  The same record
  feeds three counter (``C``) tracks — ``step_tokens``, ``kv_blocks``,
  ``active_slots`` — so Perfetto draws budget utilization as a graph.
* **global instants** — allocator/cache causality: ``kv_pressure`` (the
  free list ran short and the evictor was consulted), ``prefix_evict``
  (args: n, cause ∈ {capacity, pressure}), ``prefix_insert``.

**Determinism.**  Event *structure* — order, names, phases, args — is a
pure function of (trace, code): wall-clock enters only through ``ts`` /
``dur`` fields, never args.  :func:`structure_fingerprint` hashes the
canonical JSON of events with ``ts``/``dur`` stripped; same-seed replays
fingerprint identically (property-tested), which is what lets CI smoke-
assert a trace artifact without pinning timings.

**Stream format** (kind ``OBS_TRACE_STREAM``, schema v1).  One JSON object
per line.  Line 1 is a header carrying kind, stream + trace schema
versions, git revision, clock, and segment index; the three Perfetto meta
events and every emitted event follow as ordinary event lines (full, with
``ts``/``dur``); a footer line (``{"footer": true, ...}``) closes each
segment with the running event count and — on ``finalize()`` — the final
structure fingerprint.  Rotation renames the active file to
``<path>.1``, ``<path>.2``, ... and reopens ``<path>`` fresh, so the active
path is always the newest segment and readers chain ``<path>.1 ..
<path>.N, <path>`` back into one logical stream.  The incremental hasher
feeds ``"["``, then comma-separated canonical JSON of each ts/dur-stripped
event, then ``"]"`` at fingerprint time — exactly the bytes
:func:`structure_fingerprint` hashes for the same sequence, which is the
byte-for-byte identity a run can check.

The exported document is schema-versioned: ``otherData`` carries kind, schema
version, git revision, and the structure fingerprint; :func:`validate`
walks the document and re-derives the fingerprint.  The JSON loads
directly in ``chrome://tracing`` / https://ui.perfetto.dev.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import subprocess
import time

TRACE_KIND = "OBS_TRACE"
TRACE_SCHEMA_VERSION = 1

STREAM_KIND = "OBS_TRACE_STREAM"
STREAM_SCHEMA_VERSION = 1

DEFAULT_RING_CAPACITY = 4096

_PID = 1
_TID_ENGINE = 0          # engine-step track
_TID_REQUESTS = 1        # async request spans (grouped by id, not tid)

_ASYNC_PHASES = ("b", "e", "n")
_KNOWN_PHASES = _ASYNC_PHASES + ("X", "C", "i", "M")


def meta_events() -> list:
    """The Perfetto process/thread naming metadata every export carries.
    Module-level (not tracer state) so streaming sinks can seed their
    fingerprint with the same three events ``to_perfetto`` prepends."""
    return [
        {"ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
         "args": {"name": "tsar-serving-engine"}},
        {"ph": "M", "name": "thread_name", "pid": _PID,
         "tid": _TID_ENGINE, "args": {"name": "engine steps"}},
        {"ph": "M", "name": "thread_name", "pid": _PID,
         "tid": _TID_REQUESTS, "args": {"name": "requests"}},
    ]


def _canon(obj) -> str:
    """Canonical one-line JSON (sorted keys, no spaces) — the byte
    representation both the fingerprint and the JSONL stream use."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class NullTracer:
    """No-op recorder; the engine's default.  Emit sites guard on
    ``enabled`` so the disabled path never constructs event args."""

    enabled = False
    __slots__ = ()

    def begin(self, uid, name, **args):
        pass

    def end(self, uid, name, **args):
        pass

    def mark(self, uid, name, **args):
        pass

    def instant(self, name, **args):
        pass

    def step(self, dur_s, **args):
        pass

    def reset(self):
        pass


NULL_TRACER = NullTracer()


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

class MemorySink:
    """Keep every event in a list.  ``events`` is the live list, so
    callers reading ``tracer.events`` see every event so far."""

    kind = "memory"

    def __init__(self):
        self.events: list = []
        self.n_appended = 0

    def append(self, e: dict):
        self.events.append(e)
        self.n_appended += 1

    def recent(self, limit: int = 512) -> list:
        return self.events[-limit:] if limit else list(self.events)

    def reset(self):
        self.events = []


class RingSink:
    """Fixed-capacity flight recorder: a ``deque`` keeps the last
    ``capacity`` events and silently drops the oldest.  Cheap enough to
    leave always-on; incident snapshots dump ``recent()`` post-hoc."""

    kind = "ring"

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        self.capacity = int(capacity)
        self.n_appended = 0
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)

    @property
    def events(self) -> list:
        return list(self._buf)

    @property
    def n_dropped(self) -> int:
        return max(0, self.n_appended - len(self._buf))

    def append(self, e: dict):
        self._buf.append(e)
        self.n_appended += 1

    def recent(self, limit: int = 512) -> list:
        out = list(self._buf)
        return out[-limit:] if limit else out

    def reset(self):
        self._buf.clear()
        self.n_appended = 0


class TeeSink:
    """Fan one event stream out to several sinks.  ``events``/``recent``
    read from the *first* (primary) sink, so ``TeeSink(MemorySink(),
    StreamingSink(path))`` behaves like a memory tracer that also streams
    to disk."""

    kind = "tee"

    def __init__(self, *sinks):
        if not sinks:
            raise ValueError("TeeSink needs at least one sink")
        self.sinks = tuple(sinks)

    @property
    def events(self):
        return self.sinks[0].events

    def append(self, e: dict):
        for s in self.sinks:
            s.append(e)

    def recent(self, limit: int = 512) -> list:
        return self.sinks[0].recent(limit)

    def reset(self):
        for s in self.sinks:
            s.reset()


class StreamingSink:
    """Bounded-memory JSONL append to disk with size-based rotation.

    Memory never holds more than ``flush_every`` buffered lines plus a
    ``tail_events`` deque for incident snapshots — ``peak_resident_events``
    records the observed maximum so tests can assert the bound.  The
    structure fingerprint is maintained incrementally (see module
    docstring) and ``finalize()`` returns it alongside stream provenance;
    it matches :func:`structure_fingerprint` over the same sequence
    byte-for-byte, meta events included.

    ``reset()`` implements the warm-up contract: rotated segments are
    deleted, the active file is truncated back to a fresh header, and the
    hasher is re-seeded — so ``ServingEngine.reset_run_stats()`` leaves no
    warm-up events in the saved stream.
    """

    kind = "stream"

    def __init__(self, path, *, max_segment_bytes: int = 64 << 20,
                 flush_every: int = 256, tail_events: int = 512,
                 rev: str | None = None):
        self.path = str(path)
        self.max_segment_bytes = int(max_segment_bytes)
        self.flush_every = max(1, int(flush_every))
        self.peak_resident_events = 0
        self._rev = git_rev() if rev is None else rev
        self._tail: collections.deque = collections.deque(
            maxlen=max(1, int(tail_events)))
        self._f = None
        self._closed = False
        self._info: dict | None = None
        self._open_run()

    # -- lifecycle ----------------------------------------------------------

    def _open_run(self):
        self._hash = hashlib.sha256()
        self._hash.update(b"[")
        self._first = True
        self.n_events = 0
        self._buf: list = []
        self._segment = 0
        self._rotated: list = []      # closed segment paths, oldest first
        self._f = open(self.path, "w")
        self._seg_bytes = 0
        self._write_header()
        for m in meta_events():
            self.append(m)

    def _write_header(self):
        line = _canon({"kind": STREAM_KIND,
                       "stream_version": STREAM_SCHEMA_VERSION,
                       "schema_version": TRACE_SCHEMA_VERSION,
                       "git_rev": self._rev,
                       "clock": "perf_counter_rel_us",
                       "segment": self._segment}) + "\n"
        self._f.write(line)
        self._seg_bytes += len(line)

    @property
    def events(self):
        raise RuntimeError(
            "StreamingSink does not retain events in memory; read the "
            "stream back with repro_torch.obs.trace.read_stream(path) / "
            "StreamReader, or tee through a MemorySink")

    def recent(self, limit: int = 512) -> list:
        out = list(self._tail)
        return out[-limit:] if limit else out

    def append(self, e: dict):
        if self._closed:
            raise RuntimeError(f"StreamingSink({self.path}) is finalized")
        s = _canon({k: v for k, v in e.items() if k not in ("ts", "dur")})
        if not self._first:
            self._hash.update(b",")
        self._first = False
        self._hash.update(s.encode("utf-8"))
        line = _canon(e) + "\n"
        self._buf.append(line)
        self._tail.append(e)
        self.n_events += 1
        self._seg_bytes += len(line)
        if len(self._buf) > self.peak_resident_events:
            self.peak_resident_events = len(self._buf)
        if len(self._buf) >= self.flush_every:
            self.flush()
        if self._seg_bytes >= self.max_segment_bytes:
            self._rotate()

    def flush(self):
        if self._buf:
            self._f.write("".join(self._buf))
            self._buf = []
        self._f.flush()

    def fingerprint(self) -> str:
        """Structure fingerprint over everything appended so far — equal to
        ``structure_fingerprint(meta_events() + events)`` byte-for-byte."""
        h = self._hash.copy()
        h.update(b"]")
        return "sha256:" + h.hexdigest()

    def _write_footer(self, final: bool):
        foot = {"footer": True, "segment": self._segment,
                "n_events": self.n_events}
        if final:
            foot["fingerprint"] = self.fingerprint()
            foot["complete"] = True
            foot["segments"] = self._segment + 1
        self._f.write(_canon(foot) + "\n")

    def _rotate(self):
        self.flush()
        self._write_footer(final=False)
        self._f.close()
        rotated = f"{self.path}.{len(self._rotated) + 1}"
        os.replace(self.path, rotated)
        self._rotated.append(rotated)
        self._segment += 1
        self._f = open(self.path, "w")
        self._seg_bytes = 0
        self._write_header()

    def finalize(self) -> dict:
        """Flush, write the closing footer (with the final fingerprint),
        close the file, and return stream provenance.  Idempotent."""
        if self._closed:
            return dict(self._info)
        self.flush()
        self._write_footer(final=True)
        self._f.close()
        self._closed = True
        self._info = {"path": self.path, "kind": STREAM_KIND,
                      "stream_version": STREAM_SCHEMA_VERSION,
                      "schema_version": TRACE_SCHEMA_VERSION,
                      "fingerprint": self.fingerprint(),
                      "n_events": self.n_events,
                      "segments": self._segment + 1}
        return dict(self._info)

    close = finalize

    def reset(self):
        """Truncate back to an empty stream: delete rotated segments,
        rewrite the header, re-seed the fingerprint (meta events included).
        Called via ``EventTracer.reset()`` so warm-up events never leak
        into the saved stream."""
        if self._closed:
            raise RuntimeError(
                f"StreamingSink({self.path}) is finalized; cannot reset")
        self._buf = []
        self._tail.clear()
        self._f.close()
        for p in self._rotated:
            try:
                os.remove(p)
            except OSError:
                pass
        self._open_run()


class EventTracer:
    """``trace_event`` recorder over a pluggable sink (see module
    docstring).  Default sink is :class:`MemorySink` — identical behavior
    to the original in-memory recorder, ``tracer.events`` included."""

    enabled = True

    def __init__(self, clock=time.perf_counter, sink=None):
        self._clock = clock
        self._rebase()
        self.sink = MemorySink() if sink is None else sink

    def _rebase(self):
        self._t0 = self._clock()
        # (perf_counter_ns, time_ns) read together: maps the epoch onto Unix
        # time, the clock of a ``torch.profiler`` trace.  Kept in memory only,
        # never in a saved document or a stream header.
        self._anchor = (time.perf_counter_ns(), time.time_ns())

    def unix_ns(self, ts_us: float) -> int:
        """An event's ``ts`` (microseconds from the epoch) in Unix
        nanoseconds, for the default ``time.perf_counter`` clock: on the
        host clock of a ``torch.profiler`` trace, whose ranges it then lines
        up with to the anchor's precision."""
        perf_ns, unix_ns = self._anchor
        return unix_ns + round((self._t0 + ts_us * 1e-6) * 1e9) - perf_ns

    @property
    def events(self) -> list:
        """The recorded events, when the sink retains them (memory/ring/
        tee-with-memory-primary).  Raises for streaming-only sinks."""
        return self.sink.events

    def reset(self):
        """Drop recorded events and rebase the epoch — called by
        ``ServingEngine.reset_run_stats`` so warm-up never pollutes the
        steady-state trace.  A streaming sink truncates its on-disk
        segments; a ring/memory sink clears."""
        self._rebase()
        self.sink.reset()

    # -- emit primitives -----------------------------------------------------

    def _ts(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def begin(self, uid: int, name: str, **args):
        """Open an async span on request ``uid``'s track."""
        self.sink.append({"ph": "b", "cat": "req", "id": int(uid),
                          "name": name, "pid": _PID, "tid": _TID_REQUESTS,
                          "ts": self._ts(), "args": args})

    def end(self, uid: int, name: str, **args):
        """Close the matching async span."""
        self.sink.append({"ph": "e", "cat": "req", "id": int(uid),
                          "name": name, "pid": _PID, "tid": _TID_REQUESTS,
                          "ts": self._ts(), "args": args})

    def mark(self, uid: int, name: str, **args):
        """Async instant on request ``uid``'s track."""
        self.sink.append({"ph": "n", "cat": "req", "id": int(uid),
                          "name": name, "pid": _PID, "tid": _TID_REQUESTS,
                          "ts": self._ts(), "args": args})

    def instant(self, name: str, **args):
        """Global instant (allocator pressure, cache eviction)."""
        self.sink.append({"ph": "i", "s": "g", "name": name, "pid": _PID,
                          "tid": _TID_ENGINE, "ts": self._ts(),
                          "args": args})

    def step(self, dur_s: float, **args):
        """One engine step: a complete event on the engine track (``ts`` is
        the step start) plus counter samples for the budget/occupancy
        tracks.  ``args`` must be deterministic (no wall-clock values)."""
        add = self.sink.append
        ts = self._ts() - dur_s * 1e6
        add({"ph": "X", "name": "step", "pid": _PID,
             "tid": _TID_ENGINE, "ts": ts,
             "dur": dur_s * 1e6, "args": args})
        ctr = {"ph": "C", "pid": _PID, "tid": _TID_ENGINE, "ts": ts}
        if "planned" in args:
            add({**ctr, "name": "step_tokens",
                 "args": {"planned": args["planned"],
                          "realized": args.get("realized", 0)}})
        if "kv_blocks" in args:
            add({**ctr, "name": "kv_blocks",
                 "args": {"in_use": args["kv_blocks"]}})
        if "active_slots" in args:
            add({**ctr, "name": "active_slots",
                 "args": {"slots": args["active_slots"]}})

    # -- export --------------------------------------------------------------

    def _meta_events(self) -> list:
        return meta_events()

    def to_perfetto(self, rev: str | None = None) -> dict:
        evs = meta_events() + list(self.events)
        return {
            "displayTimeUnit": "ms",
            "traceEvents": evs,
            "otherData": {
                "kind": TRACE_KIND,
                "schema_version": TRACE_SCHEMA_VERSION,
                "git_rev": git_rev() if rev is None else rev,
                "clock": "perf_counter_rel_us",
                "fingerprint": structure_fingerprint(evs),
            },
        }

    def save(self, path: str, rev: str | None = None) -> dict:
        doc = self.to_perfetto(rev=rev)
        save_doc(doc, path)
        return doc


# ---------------------------------------------------------------------------
# structure fingerprint + document IO/validation
# ---------------------------------------------------------------------------

def git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
    except Exception:
        return "unknown"


def structure(events: list) -> list:
    """Events with the wall-clock fields (``ts``/``dur``) stripped — the
    deterministic side of a trace."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def structure_fingerprint(events: list) -> str:
    s = _canon(structure(events))
    return "sha256:" + hashlib.sha256(s.encode("utf-8")).hexdigest()


def dumps(doc: dict) -> str:
    """Canonical serialization (sorted keys, fixed separators, trailing
    newline)."""
    return _canon(doc) + "\n"


def save_doc(doc: dict, path: str) -> None:
    validate(doc)
    with open(path, "w") as f:
        f.write(dumps(doc))


def load(path: str) -> dict:
    with open(path) as f:
        return validate(json.load(f))


def _fail(path: str, msg: str):
    raise ValueError(f"{TRACE_KIND} schema: {path}: {msg}")


def _validate_event(e, p: str):
    if not isinstance(e, dict):
        _fail(p, "expected object")
    ph = e.get("ph")
    if ph not in _KNOWN_PHASES:
        _fail(f"{p}.ph", f"unknown phase {ph!r}")
    if not isinstance(e.get("name"), str):
        _fail(f"{p}.name", "expected string")
    if ph != "M" and not isinstance(e.get("ts"), (int, float)):
        _fail(f"{p}.ts", "expected number")
    if ph in _ASYNC_PHASES:
        if "id" not in e or not isinstance(e.get("cat"), str):
            _fail(p, "async event needs id + cat")
    if ph == "X" and not isinstance(e.get("dur"), (int, float)):
        _fail(f"{p}.dur", "complete event needs dur")
    if ph == "C" and not isinstance(e.get("args"), dict):
        _fail(f"{p}.args", "counter event needs args")


def validate(doc: dict) -> dict:
    """Structural validation + fingerprint re-derivation; returns ``doc``."""
    if not isinstance(doc, dict):
        _fail("$", "expected object")
    for k in ("traceEvents", "otherData"):
        if k not in doc:
            _fail("$", f"missing key {k!r}")
    od = doc["otherData"]
    if not isinstance(od, dict):
        _fail("$.otherData", "expected object")
    for k in ("kind", "schema_version", "git_rev", "fingerprint"):
        if k not in od:
            _fail("$.otherData", f"missing key {k!r}")
    if od["kind"] != TRACE_KIND:
        _fail("$.otherData.kind", f"{od['kind']!r} != {TRACE_KIND!r}")
    if od["schema_version"] != TRACE_SCHEMA_VERSION:
        _fail("$.otherData.schema_version",
              f"{od['schema_version']!r} != {TRACE_SCHEMA_VERSION}")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        _fail("$.traceEvents", "expected list")
    for i, e in enumerate(evs):
        _validate_event(e, f"$.traceEvents[{i}]")
    fp = structure_fingerprint(evs)
    if od["fingerprint"] != fp:
        _fail("$.otherData.fingerprint",
              f"{od['fingerprint']!r} does not match event structure "
              f"({fp!r})")
    return doc


# ---------------------------------------------------------------------------
# stream reading
# ---------------------------------------------------------------------------

def _stream_fail(path: str, msg: str):
    raise ValueError(f"{STREAM_KIND} schema: {path}: {msg}")


def stream_segments(path: str) -> list:
    """Segment files of a (possibly rotated) stream, oldest first: the
    rotated ``<path>.1 .. <path>.N`` then the active ``<path>``."""
    out = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    if not os.path.exists(path):
        _stream_fail(path, "no such stream file")
    out.append(path)
    return out


class StreamReader:
    """Iterate events out of a JSONL stream (chaining rotated segments),
    re-deriving the structure fingerprint as it goes.

    After exhaustion: ``fingerprint`` holds the re-derived fingerprint,
    ``n_events`` the event count, ``complete`` whether a final footer was
    present — and, when it was, the recorded fingerprint has been checked
    against the re-derived one (a tampered or reordered stream raises).
    A footer-less stream (the writer died mid-run) is still readable;
    ``complete`` stays False and no fingerprint check applies.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.header: dict | None = None
        self.footer: dict | None = None
        self.fingerprint: str | None = None
        self.complete: bool | None = None
        self.n_events = 0

    def _check_header(self, obj: dict, where: str):
        if obj.get("kind") != STREAM_KIND:
            _stream_fail(where, f"kind {obj.get('kind')!r} != {STREAM_KIND!r}")
        if obj.get("stream_version") != STREAM_SCHEMA_VERSION:
            _stream_fail(where, f"stream_version {obj.get('stream_version')!r}"
                                f" != {STREAM_SCHEMA_VERSION}")
        if obj.get("schema_version") != TRACE_SCHEMA_VERSION:
            _stream_fail(where, f"schema_version {obj.get('schema_version')!r}"
                                f" != {TRACE_SCHEMA_VERSION}")

    def __iter__(self):
        h = hashlib.sha256()
        h.update(b"[")
        first = True
        n = 0
        segs = stream_segments(self.path)
        for seg in segs:
            active = seg == segs[-1]
            with open(seg) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    where = f"{seg}:{lineno}"
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        if active:
                            break    # truncated tail: writer died mid-line
                        _stream_fail(where, "not valid JSON")
                    if not isinstance(obj, dict):
                        _stream_fail(where, "expected object")
                    if "kind" in obj and "ph" not in obj:
                        self._check_header(obj, where)
                        if self.header is None:
                            self.header = obj
                        continue
                    if obj.get("footer"):
                        self.footer = obj
                        continue
                    _validate_event(obj, where)
                    if not first:
                        h.update(b",")
                    first = False
                    h.update(_canon({k: v for k, v in obj.items()
                                     if k not in ("ts", "dur")}).encode())
                    n += 1
                    yield obj
        if self.header is None:
            _stream_fail(self.path, "no stream header line")
        hc = h.copy()
        hc.update(b"]")
        self.fingerprint = "sha256:" + hc.hexdigest()
        self.n_events = n
        foot = self.footer
        self.complete = bool(foot and foot.get("complete")
                             and "fingerprint" in foot)
        if self.complete:
            if foot["fingerprint"] != self.fingerprint:
                _stream_fail(self.path,
                             f"recorded fingerprint {foot['fingerprint']!r} "
                             f"does not match event structure "
                             f"({self.fingerprint!r})")
            if foot.get("n_events") != n:
                _stream_fail(self.path,
                             f"footer n_events {foot.get('n_events')} != "
                             f"{n} events read")


def read_stream(path: str) -> tuple:
    """Read a whole stream into memory: ``(events, reader)`` with the
    reader's post-iteration provenance fields populated."""
    r = StreamReader(path)
    return list(r), r


def stream_to_perfetto(path: str) -> dict:
    """Re-assemble a JSONL stream into a validated ``OBS_TRACE`` Perfetto
    document (meta events are part of the stream, so this is just
    re-wrapping)."""
    evs, r = read_stream(path)
    return validate({
        "displayTimeUnit": "ms",
        "traceEvents": evs,
        "otherData": {
            "kind": TRACE_KIND,
            "schema_version": r.header["schema_version"],
            "git_rev": r.header.get("git_rev", "unknown"),
            "clock": r.header.get("clock", "perf_counter_rel_us"),
            "fingerprint": r.fingerprint,
        },
    })


def load_any(path: str) -> tuple:
    """Sniff a trace file: returns ``("stream", StreamReader)`` for JSONL
    streams, ``("doc", dict)`` for whole Perfetto documents (validated)."""
    with open(path) as f:
        head = f.readline()
    try:
        obj = json.loads(head)
    except ValueError:
        obj = None
    if isinstance(obj, dict) and obj.get("kind") == STREAM_KIND:
        return "stream", StreamReader(path)
    return "doc", load(path)


# ---------------------------------------------------------------------------
# torch.profiler ranges: spans inside the program, the step annotation
# ---------------------------------------------------------------------------

STEP_RANGE = "tsar_engine_step"
SPAN_PREFIX = "tsar."

_NO_RANGE = contextlib.nullcontext()
# Set by :func:`spans` around an engine step, never by code the step runs.
_spans_on = False


def _range(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared no-op context (no range object is made)."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


def span(name: str):
    """Context manager marking one layer of the program as a
    ``torch.profiler`` range named ``tsar.<name>``: the host time inside
    it, and the device time of the kernels launched inside it, belong to
    that layer (the innermost open range).  Off (outside :func:`spans`) it
    costs one read of a module-level switch and returns a shared no-op
    context; on while no profiler records, one more call."""
    if not _spans_on:
        return _NO_RANGE
    return _range(SPAN_PREFIX + name)


@contextlib.contextmanager
def spans():
    """Turn :func:`span` on for the body; the previous setting returns
    after it.  The engine wraps a step in it when built with
    ``profiler_annotations=True``."""
    global _spans_on
    prev, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = prev


def step_annotation(step_num: int):
    """Context manager marking one engine step's model call as a
    ``torch.profiler`` range named ``tsar_engine_step#<step_num>`` (torch's
    own ``ProfilerStep#<n>`` spelling: a ``record_function`` args string
    does not reach the trace), so a device trace captured with
    ``torch.profiler.profile(...)`` lines up with the engine's step
    records, the counterpart of the reference's
    ``jax.profiler.StepTraceAnnotation``.  Kernels launched inside the
    range and outside every :func:`span` are its own device time.  Outside
    a profiler it is a no-op context."""
    return _range(f"{STEP_RANGE}#{int(step_num)}")
