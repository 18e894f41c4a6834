"""Lightweight span tracer: nestable context-manager spans over
``time.perf_counter`` with a ring-buffer recorder (torch port of
``repro.trace.tracer``).

The tracer records the per-phase costs of the aggregation pipeline (encode /
collective / finish in ``core/bucketer.py``, the switch emulator's rounds,
the autotune probes) from ordinary runs, for the cost-model autotuner
(``repro_torch.autotune``). Design constraints, in order:

1. **Near-zero disabled path.** ``span()`` with the tracer disabled is one
   attribute load, one bool test, and the return of a shared no-op
   singleton: no allocation, no clock read.
2. **Attribution through sync boundaries.** CUDA launches and
   ``async_op=True`` collectives return before the work is done: a
   ``perf_counter`` pair around them measures the launch. A span therefore
   exposes ``sync(value)``, which waits *inside* the span for every
   collective work handle in ``value`` and synchronizes the CUDA device of
   every CUDA tensor in it, so the device work lands in the span that issued
   it, and marks the span ``synced=True``. A CPU tensor is ready when the
   call that made it returns, so it counts as synced without a wait. A
   traced run therefore serializes what it syncs: its times are not those of
   an untraced run.
3. **Bounded memory.** Spans land in a ``deque(maxlen=capacity)`` ring:
   long-running jobs keep the most recent ``capacity`` spans.

Spans are used in the ``with`` form only::

    with trace.span("bucketer.encode", bucket=i, phase="encode") as sp:
        state = encode(buf)
        sp.sync(state)
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from time import perf_counter

import torch

SCHEMA_VERSION = 1

_DEFAULT_CAPACITY = 1 << 16


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


class Span:
    """One timed region. Context-manager only (see module doc)."""

    __slots__ = ("name", "tags", "sid", "parent", "depth", "tid",
                 "t0", "t1", "synced", "_tracer")

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
        self.t0 = perf_counter()
        return self

    def end(self) -> None:
        self.t1 = perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # mismatched exits: unwind to self
            while stack and stack.pop() is not self:
                pass
        self._tracer._record(self)

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

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, sp: Span) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(sp.to_dict())

    def span(self, name: str, **tags) -> Span | _NullSpan:
        if not self.active:
            return NULL_SPAN
        return Span(self, name, tags)

    @property
    def spans(self) -> list[dict]:
        """Recorded span dicts, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0


# ---------------------------------------------------------------------------
# the global tracer — what instrumented modules talk to
# ---------------------------------------------------------------------------

_GLOBAL = Tracer(active=False)


def span(name: str, **tags):
    """Open a span on the global tracer (``with trace.span(...) as sp:``).

    The hot-path entry point: when tracing is disabled this is one attribute
    load + bool test + shared-singleton return."""
    tr = _GLOBAL
    if not tr.active:
        return NULL_SPAN
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
