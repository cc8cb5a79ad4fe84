"""The port's spans and counters: one tracer for the inference pipeline
and the training step, on the profiler's clock.

A unit (`unit("scan")`, `unit("step")`) is the root of a tree of spans
(`span("pre")`, `span("model")`, ...); a counter (`count("h2d_copies")`)
adds to the unit it is counted in. The tracer is on

* while a torch.profiler records (the benchmark's profiled part, the
  epoch loop's PROFILE_DIR epoch),
* inside a unit opened with `force=True`, by a caller that returns its
  own times (`TrainStep(timed=True)`, the pipeline's unpack=True calls),
* inside `recording()`.

Off, a unit, a span or a counter reads this module's flag and the
profiler's, and nothing more: no record_function, no CUDA event, no
record.

On, a span records its name, its host start and end (time.perf_counter
seconds), its parent span and its unit (the root's id). A span opened
with a `device` of type cuda also records a CUDA event on that device's
current stream at its start and at its end (or at `end_device()`); the
pair is read when asked for, never waited for: a pair whose end has not
completed reads None. On a CPU device a span's device time is its host
time. While a profiler records, each span below its unit is also a
record_function range named "dram.<name>" with the unit's id as its
args, so the program's stages sit in the profiler's own timeline; the
unit itself is not a range, so the profiler's top-level ranges are the
stages.

The last MAX_SPANS spans are kept in memory; `snapshot()` returns them,
their units and the counters, with device times resolved.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

MAX_SPANS = 1 << 16

# the profiler's own flag (a C call, ~0.1 us)
_profiling = torch.autograd._profiler_enabled

_forced = 0  # open recording() blocks and forced units
_ids = itertools.count(1)
_spans = collections.deque(maxlen=MAX_SPANS)
_totals = collections.Counter()
_local = threading.local()
# the pipeline's scans may run in threads (sharded inference): the
# shared flag and totals change under this lock
_lock = threading.Lock()


def _force(n):
    global _forced
    with _lock:
        _forced += n


def _stack():
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Off:
    """What a unit or a span is while the tracer is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end_device(self):
        pass


_OFF = _Off()


class Span:
    __slots__ = ("id", "name", "root", "unit", "parent", "t0", "t1",
                 "device", "events", "dev_ms", "force", "counters",
                 "members", "_root", "_range")

    def __init__(self, name, device, root, force):
        self.name, self.root, self.force = name, root, force
        self.device = None if device is None else torch.device(device)
        self.events = None
        self.dev_ms = None
        self.counters = collections.Counter() if root else None
        self.members = [] if root else None
        self.t1 = None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        if self.root:
            self.unit, self._root = self.id, self
        else:
            self._root = up._root if up is not None else None
            self.unit = self._root.id if self._root is not None else None
        if self.force:
            _force(1)
        self._range = None
        if not self.root and _profiling():
            self._range = torch.autograd.profiler.record_function(
                "dram." + self.name, str(self.unit))
            self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.events = [torch.cuda.Event(enable_timing=True), None]
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def end_device(self):
        """End the span's device time here (its host time runs on to
        its exit): the device work it times is all queued before this
        point, and what follows on the host may wait for it."""
        if self.events is not None and self.events[1] is None:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.device))
            self.events[1] = e

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        self.end_device()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.force:
            _force(-1)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._root is not None and self._root is not self:
            self._root.members.append(self)
        _spans.append(self)
        return False

    @property
    def host_ms(self):
        return None if self.t1 is None else (self.t1 - self.t0) * 1e3

    @property
    def device_ms(self):
        """The device ms between the span's two events, None until the
        end event has completed (or without a device); on a CPU device
        the host ms."""
        if self.dev_ms is not None or self.device is None:
            return self.dev_ms
        if self.events is None:
            return self.host_ms
        a, b = self.events
        if b is None or not b.query():
            return None
        self.dev_ms = a.elapsed_time(b)
        self.events = None
        return self.dev_ms

    def device_ms_of(self, name):
        """The summed device ms of this unit's spans named `name`; None
        where one of them has none yet (or there is none)."""
        ms = [s.device_ms for s in self.members if s.name == name]
        if not ms or any(m is None for m in ms):
            return None
        return float(sum(ms))


def unit(name, force=False):
    """The root span of one unit of work (a scan, a step), timed on the
    host. With `force` the tracer is on inside it, for a caller that
    reads its spans' times (`device_ms_of`)."""
    if not (force or _forced or _profiling()):
        return _OFF
    return Span(name, None, True, force)


def span(name, device=None):
    """A span inside the current unit; with a `device`, timed on it as
    well (CUDA events on its current stream)."""
    if not (_forced or _profiling()):
        return _OFF
    return Span(name, device, False, False)


def count(name, n=1):
    """Add `n` to counter `name`, in the current unit and in total."""
    if not (_forced or _profiling()):
        return
    with _lock:
        _totals[name] += n
    stack = _stack()
    if stack and stack[-1]._root is not None:
        stack[-1]._root.counters[name] += n


class recording:
    """The tracer on inside the block (tests; a caller's own reading)."""

    def __enter__(self):
        _force(1)
        return self

    def __exit__(self, *exc):
        _force(-1)
        return False


def on():
    """Whether a span opened now would record."""
    return bool(_forced or _profiling())


def reset():
    """Forget every recorded span and counter."""
    _spans.clear()
    _totals.clear()


def snapshot():
    """The record: {"spans": [{"id", "name", "unit", "parent", "t0",
    "t1", "host_ms", "device_ms"}] in start order, the units' roots
    among them (parent None or the enclosing span, unit = id);
    "units": [{"unit", "name", "host_ms", "counters"}] of the roots
    recorded; "counters": the totals}. A device time not yet complete
    reads None."""
    spans = sorted(_spans, key=lambda s: s.id)
    out = [{"id": s.id, "name": s.name, "unit": s.unit, "parent": s.parent,
            "t0": s.t0, "t1": s.t1, "host_ms": s.host_ms,
            "device_ms": s.device_ms} for s in spans]
    units = [{"unit": s.id, "name": s.name, "host_ms": s.host_ms,
              "counters": dict(s.counters)} for s in spans if s.root]
    return {"spans": out, "units": units, "counters": dict(_totals)}
