"""Trace serialization: JSONL (the cost-model interchange format) and
chrome://tracing (the human one); torch port of ``repro.trace.export``, with
the same schema, so each side reads the other's files.

JSONL layout — line 1 is a header object carrying the schema version, every
following line is one span dict::

    {"schema": 1, "kind": "repro-trace", "clock": "perf_counter", ...}
    {"name": "bucketer.encode", "id": 3, "parent": 2, "depth": 1, ...}

``read_jsonl`` refuses files whose header version it does not know, so a
cost model never silently fits fields that changed meaning. Spans that
recorded device events add ``dev_ts`` and ``dev_dur`` (the stream's
interval on the same clock, tracer module doc); a reader that does not know
them skips them, so the schema stays 1.
"""
from __future__ import annotations

import json
import platform
from typing import Iterable

from repro_torch.trace.tracer import SCHEMA_VERSION, Tracer


def _spans_of(trace) -> list[dict]:
    if isinstance(trace, Tracer):
        return trace.spans
    return list(trace)


def header(extra: dict | None = None) -> dict:
    h = {
        "schema": SCHEMA_VERSION,
        "kind": "repro-trace",
        "clock": "perf_counter",
        "host": platform.node(),
    }
    if extra:
        h.update(extra)
    return h


def write_jsonl(trace: Tracer | Iterable[dict], path, *,
                extra_header: dict | None = None) -> str:
    """Write header + one span per line; returns the path written."""
    spans = _spans_of(trace)
    with open(path, "w") as f:
        f.write(json.dumps(header(extra_header)) + "\n")
        for sp in spans:
            f.write(json.dumps(sp) + "\n")
    return str(path)


def read_jsonl(path) -> tuple[dict, list[dict]]:
    """Load (header, spans) back; raises ValueError on a missing header or
    an unknown schema version."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"empty trace file: {path}")
    head = json.loads(lines[0])
    if head.get("kind") != "repro-trace":
        raise ValueError(
            f"{path} is not a repro trace (missing header line; "
            f"first line: {lines[0][:80]!r})")
    if head.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"{path} has trace schema {head.get('schema')!r}; this reader "
            f"understands schema {SCHEMA_VERSION}")
    return head, [json.loads(ln) for ln in lines[1:]]


DEVICE_PID = 1  # the chrome process whose row holds the spans' device intervals


def to_chrome(trace: Tracer | Iterable[dict]) -> dict:
    """chrome://tracing / Perfetto "trace event" JSON (complete 'X' events;
    perf_counter seconds -> microsecond timestamps). A span with a device
    interval draws it a second time on the device row (process
    ``DEVICE_PID``, under the host's), on the same clock."""
    events, device = [], False
    for sp in _spans_of(trace):
        event = {
            "name": sp["name"],
            "ph": "X",
            "ts": sp["ts"] * 1e6,
            "dur": sp["dur"] * 1e6,
            "pid": 0,
            "tid": sp.get("tid", 0),
            "cat": str(sp.get("tags", {}).get("phase", "span")),
            "args": sp.get("tags", {}),
        }
        events.append(event)
        if "dev_ts" in sp:
            device = True
            events.append(dict(event, ts=sp["dev_ts"] * 1e6, dur=sp["dev_dur"] * 1e6,
                               pid=DEVICE_PID, tid=0))
    if device:
        events += [{"name": "process_name", "ph": "M", "pid": pid, "args": {"name": name}}
                   for pid, name in ((0, "host"), (DEVICE_PID, "device (CUDA stream)"))]
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": header(),
    }


def write_chrome(trace: Tracer | Iterable[dict], path) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome(trace), f)
    return str(path)
