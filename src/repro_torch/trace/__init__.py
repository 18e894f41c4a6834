"""Span tracing for the aggregation pipeline (torch port of ``repro.trace``).

Hot-path API (near-zero when disabled)::

    from repro_torch import trace

    with trace.span("bucketer.encode", bucket=i, phase="encode") as sp:
        state = encode(buf)
        sp.sync(state)      # waits for the device -> its work lands here

Control/export API::

    trace.enable(); ... ; trace.export.write_jsonl(trace.get(), path)

CLI threading: ``trace.add_trace_args(parser)`` + ``trace.from_args(ns)``.
"""
from repro_torch.trace import export  # noqa: F401
from repro_torch.trace.cli import TraceSession, add_trace_args, from_args  # noqa: F401
from repro_torch.trace.export import (  # noqa: F401
    read_jsonl, to_chrome, write_chrome, write_jsonl,
)
from repro_torch.trace.tracer import (  # noqa: F401
    NULL_SPAN, SCHEMA_VERSION, Span, Tracer, disable, enable, enabled, get,
    span, wait_for,
)
