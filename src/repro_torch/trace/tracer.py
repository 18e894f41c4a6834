"""Lightweight span tracer: nestable context-manager spans over
``time.perf_counter`` with a ring-buffer recorder (torch port of
``repro.trace.tracer``), plus the device's own time of each span and a
bridge into ``torch.profiler``.

The tracer records the per-phase costs of the aggregation pipeline (encode /
collective / finish in ``core/bucketer.py``, the switch emulator's rounds,
the autotune probes) from ordinary runs, for the cost-model autotuner
(``repro_torch.autotune``), and the phases of a training step
(``train.step`` > ``train.forward_backward``, ``agg.allreduce_tree``,
``train.optimizer`` in ``train/step.py``). Design constraints, in order:

1. **Near-zero disabled path.** ``span()`` with the tracer disabled is one
   attribute load, one bool test, one more bool test (is ``torch.profiler``
   recording?), and the return of a shared no-op singleton: no allocation,
   no clock read.
2. **Device time two ways: events, and sync boundaries.** CUDA launches and
   ``async_op=True`` collectives return before the work is done: a
   ``perf_counter`` pair around them measures the launch.
   *Events.* When CUDA is in use, an enabled span records a CUDA timing
   event on the current stream as it opens and as it closes (from a small
   pool, without synchronizing). Its device interval is the stream's time
   from the span's first queued work to its last, idle included: the
   phase's share of the stream, in an untraced step's order. The events are
   resolved only when spans are read (``Tracer.spans``, the exports) and
   placed on the host clock through one anchor (a full garbage collection,
   a synchronize, an event and a clock read) taken when the tracer is made,
   or at its first span after CUDA starts. Such spans carry ``dev_ts`` and ``dev_dur`` (seconds);
   spans without device events carry neither.
   *Sync.* A span also exposes ``sync(value)``, which waits *inside* the
   span for every collective work handle in ``value`` and synchronizes the
   CUDA device of every CUDA tensor in it, so the device work lands in the
   span's host interval too, and marks the span ``synced=True``. A CPU
   tensor is ready when the call that made it returns, so it counts as
   synced without a wait. A traced run therefore serializes what it syncs,
   and only that: its times there are not those of an untraced run.
3. **Bounded memory.** Spans land in a ``deque(maxlen=capacity)`` ring:
   long-running jobs keep the most recent ``capacity`` spans; spans whose
   events are still pending return them to the pool as the stream passes
   them.
4. **Visible to the profiler.** While ``torch.profiler`` records, every
   span, enabled or not, opens a ``record_function`` range of its own name,
   so the program's phases sit in the profiler's trace on its clock: on the
   host row, and as GPU user annotations on the device row (the profiler
   gives each launch to its innermost range, so a span whose launches all
   lie in child spans shows there through its children). A span opened
   with the tracer off then records nothing else and waits for nothing.

Spans are used in the ``with`` form only::

    with trace.span("bucketer.encode", bucket=i, phase="encode") as sp:
        state = encode(buf)
        sp.sync(state)
"""
from __future__ import annotations

import gc
import itertools
import threading
from collections import deque
from time import perf_counter

import torch
import torch.autograd.profiler as _profiler

SCHEMA_VERSION = 1

_DEFAULT_CAPACITY = 1 << 16
_PENDING = 64    # unresolved spans before the tracer retires the finished ones
_POOL = 256      # free events a tracer keeps for reuse (more than 2 x _PENDING)


def _leaves(value):
    if isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    else:
        yield value


def wait_for(value) -> bool:
    """Wait for every collective work handle in ``value`` (nested
    tuples/lists/dicts) and synchronize the CUDA device of every CUDA tensor
    in it. False when it holds neither a tensor nor a work handle."""
    found, devices = False, set()
    for leaf in _leaves(value):
        if isinstance(leaf, torch.Tensor):
            found = True
            if leaf.is_cuda:
                devices.add(leaf.device)
        elif callable(getattr(leaf, "wait", None)) and hasattr(leaf, "is_completed"):
            leaf.wait()  # a torch.distributed work handle
            found = True
    for device in devices:
        torch.cuda.synchronize(device)
    return found


class _NullSpan:
    """The disabled path: a shared, stateless no-op (falsy, so callers can
    gate expensive tag computation with ``if sp:``)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def tag(self, **tags):
        return self

    def sync(self, value):
        return value


NULL_SPAN = _NullSpan()


class _Range(_NullSpan):
    """A span opened with the tracer off while ``torch.profiler`` records:
    a ``record_function`` range of the span's name and nothing else (falsy,
    no tags, ``sync`` does not wait)."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


def _anchor():
    """(event, host clock) of one instant: the card and the heap drained, an
    event recorded, the clock read as it passes. The full collection keeps
    garbage made before tracing (a profiler's event lists take hundreds of
    ms to free) out of the first spans."""
    gc.collect()
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev, perf_counter()


class Span:
    """One timed region. Context-manager only (see module doc)."""

    __slots__ = ("name", "tags", "sid", "parent", "depth", "tid",
                 "t0", "t1", "synced", "_tracer", "_ev", "_rf")

    def __init__(self, tracer: "Tracer", name: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.sid = -1
        self.parent = -1
        self.depth = 0
        self.tid = 0
        self.t0 = 0.0
        self.t1 = 0.0
        self.synced = False
        self._ev = None
        self._rf = None

    def __bool__(self):
        return True

    def tag(self, **tags) -> "Span":
        """Attach/overwrite tags after entry (e.g. counts known only at the
        end of the region)."""
        self.tags.update(tags)
        return self

    def sync(self, value):
        """Wait for ``value`` (tensors and collective work handles, nested
        in tuples/lists/dicts), attributing its device time to this span;
        marks the span ``synced``. A value with neither leaves it unsynced."""
        if wait_for(value):
            self.synced = True
        return value

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.end()
        return False

    def start(self) -> "Span":
        # internal: callers use the ``with`` form
        stack = self._tracer._stack()
        self.sid = next(self._tracer._ids)
        self.parent = stack[-1].sid if stack else -1
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name).__enter__()
        tr = self._tracer
        if tr._cuda:
            self._ev = tr._event()
        self.t0 = perf_counter()
        return self

    def end(self) -> None:
        self.t1 = perf_counter()
        ev = self._tracer._event() if self._ev is not None else None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # mismatched exits: unwind to self
            while stack and stack.pop() is not self:
                pass
        self._tracer._record(self, ev)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "id": self.sid, "parent": self.parent,
            "depth": self.depth, "tid": self.tid, "ts": self.t0,
            "dur": self.t1 - self.t0, "synced": self.synced,
            "tags": self.tags,
        }


class Tracer:
    """Ring-buffer span recorder. One global instance serves the module-level
    ``span()`` helper; tests and the autotune profiler may build private
    ones."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *,
                 active: bool = True):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.active = bool(active)
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count()
        self._local = threading.local()
        self.dropped = 0
        # device time (module doc, 2): the anchor, pending (dict, open, close)
        # event triples, and free events; _cuda while spans record events
        self._anchor = None
        self._pending: deque = deque()
        self._free: list = []
        self._cuda = self.active and torch.cuda.is_available()
        if self._cuda and torch.cuda.is_initialized():
            self._anchor = _anchor()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        """A timing event recorded on the current stream, or None before
        CUDA has started (the anchor is taken by the first span after)."""
        if self._anchor is None:
            if not torch.cuda.is_initialized():
                return None
            self._anchor = _anchor()
        ev = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _record(self, sp: Span, ev=None) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        d = sp.to_dict()
        self._ring.append(d)
        if ev is not None:
            self._pending.append((d, sp._ev, ev))
            if len(self._pending) > _PENDING:
                self._resolve(wait=False)

    def _resolve(self, wait: bool = True) -> None:
        """Put the device interval of pending spans into their dicts, in
        order; ``wait=False`` stops at the first whose close event the
        stream has not passed."""
        anchor, t_anchor = self._anchor or (None, 0.0)
        while self._pending:
            d, ev0, ev1 = self._pending[0]
            if wait:
                ev1.synchronize()
            elif not ev1.query():
                break
            self._pending.popleft()
            d["dev_ts"] = t_anchor + 1e-3 * anchor.elapsed_time(ev0)
            d["dev_dur"] = 1e-3 * ev0.elapsed_time(ev1)
            self._free.extend((ev0, ev1)[:max(0, _POOL - len(self._free))])

    def span(self, name: str, **tags) -> Span | _NullSpan:
        if not self.active:
            return _Range(name) if _profiler._is_profiler_enabled else NULL_SPAN
        return Span(self, name, tags)

    @property
    def spans(self) -> list[dict]:
        """Recorded span dicts, oldest first (device intervals resolved)."""
        self._resolve()
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._pending.clear()
        self.dropped = 0


# ---------------------------------------------------------------------------
# the global tracer — what instrumented modules talk to
# ---------------------------------------------------------------------------

_GLOBAL = Tracer(active=False)


def span(name: str, **tags):
    """Open a span on the global tracer (``with trace.span(...) as sp:``).

    The hot-path entry point: when tracing is disabled this is one attribute
    load + bool test, one more bool test (``torch.profiler`` recording?) and
    the shared singleton's return; while the profiler records, a
    ``record_function`` range of ``name`` (module doc, 4)."""
    tr = _GLOBAL
    if not tr.active:
        if not _profiler._is_profiler_enabled:
            return NULL_SPAN
        return _Range(name)
    return Span(tr, name, tags)


def enable(capacity: int = _DEFAULT_CAPACITY) -> Tracer:
    """Turn the global tracer on (fresh ring) and return it."""
    global _GLOBAL
    _GLOBAL = Tracer(capacity, active=True)
    return _GLOBAL


def disable() -> None:
    _GLOBAL.active = False


def enabled() -> bool:
    return _GLOBAL.active


def get() -> Tracer:
    """The current global tracer (inspect ``.spans`` after a traced run)."""
    return _GLOBAL
