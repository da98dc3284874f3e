"""Event tracing.  Only the no-op recorder is ported so far: the engine runs
with it by default and every emit site guards on ``tracer.enabled``."""
from __future__ import annotations


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
