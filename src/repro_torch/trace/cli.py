"""CLI threading for the tracer (torch port of ``repro.trace.cli``): every
entry point calls ``add_trace_args(parser)`` once and ``from_args(ns)``
after parsing::

    add_trace_args(ap)
    args = ap.parse_args()
    session = trace.from_args(args)
    ...                      # instrumented code records spans
    session.finish()         # writes --trace-out (JSONL, or chrome when the
                             # path ends in .chrome.json) and prints a line

``from_args`` enables the GLOBAL tracer, so instrumentation deep in core
and switchsim records without any handle threading.
"""
from __future__ import annotations

import argparse

from repro_torch.trace import export, tracer


def add_trace_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("tracing", "span tracer (repro_torch.trace)")
    g.add_argument(
        "--trace", action="store_true",
        help="record per-phase timing spans (the train step's train.step > "
             "train.forward_backward, agg.allreduce_tree, train.optimizer; "
             "agg/bucketer/switchsim); implied by --trace-out. On a card each "
             "span also records its device interval with CUDA events, without "
             "waiting; a traced step still waits only where a span calls "
             "sync() (the aggregation's), so its time there is not an "
             "untraced step's")
    g.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write the recorded spans here on exit: JSONL with a schema "
             "header (feeds --bucket-bytes auto via --autotune-trace), or "
             "chrome://tracing JSON when PATH ends in .chrome.json")
    g.add_argument(
        "--trace-capacity", type=int, default=tracer._DEFAULT_CAPACITY,
        metavar="N", help="ring-buffer capacity in spans (oldest dropped)")
    return g


class TraceSession:
    """Handle returned by :func:`from_args`; ``finish()`` flushes the file."""

    def __init__(self, enabled: bool, path: str | None, capacity: int):
        self.path = path
        self.enabled = enabled
        if enabled:
            self.tracer = tracer.enable(capacity)
        else:
            self.tracer = None

    def finish(self) -> str | None:
        """Write ``--trace-out`` (if any) and disable the global tracer.
        Returns the path written, or None."""
        if not self.enabled:
            return None
        tracer.disable()
        tr = self.tracer
        if self.path:
            if str(self.path).endswith(".chrome.json"):
                out = export.write_chrome(tr, self.path)
            else:
                out = export.write_jsonl(tr, self.path)
            print(f"trace: {len(tr.spans)} spans -> {out}"
                  + (f" ({tr.dropped} dropped)" if tr.dropped else ""))
            return out
        print(f"trace: {len(tr.spans)} spans recorded (no --trace-out; "
              f"inspect repro_torch.trace.get().spans)")
        return None


def from_args(ns: argparse.Namespace) -> TraceSession:
    """Enable the global tracer when ``--trace``/``--trace-out`` was given."""
    path = getattr(ns, "trace_out", None)
    enabled = bool(getattr(ns, "trace", False) or path)
    capacity = getattr(ns, "trace_capacity", tracer._DEFAULT_CAPACITY)
    return TraceSession(enabled, path, capacity)
