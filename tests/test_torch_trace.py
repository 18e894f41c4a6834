"""The port's span tracer (repro_torch.trace) against the reference's
contract (tests/test_trace.py): nesting and ordering, tags, the sync
boundary (tensors and collective work handles), per-thread stacks, the
ring buffer, the global switch and its null span, the JSONL and chrome
exports, and the instrumented seams (Aggregator facade, bucketer phases,
switchsim rounds, the CLI session).

* The two packages share one JSONL schema: the port's files are read by
  ``repro.trace.read_jsonl``, the reference's by the port's, span for span.
* The disabled path is held by counting clock reads (the module's
  ``perf_counter``), not by a wall-clock bound: a disabled span reads no
  clock and records nothing, on the hot paths included.
"""
import argparse
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro import trace as jtrace  # noqa: E402
from repro.switchsim import DataplaneConfig as JaxDataplaneConfig  # noqa: E402
from repro.switchsim import NumpyDataplane as JaxNumpyDataplane  # noqa: E402
from repro.switchsim import run_aggregation as jax_run_aggregation  # noqa: E402
from repro_torch import switchsim as tsw  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core.agg import AggConfig, Aggregator  # noqa: E402
from repro_torch.trace import export, tracer  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_global():
    """Every test leaves the process-global tracer disabled."""
    yield
    trace.disable()


# ---------------------------------------------------------------------------
# span recording: nesting, ordering, tags, sync
# ---------------------------------------------------------------------------


def test_nesting_parent_depth_and_order():
    tr = tracer.Tracer()
    with tr.span("outer", job=1):
        with tr.span("mid"):
            with tr.span("inner"):
                pass
        with tr.span("mid2"):
            pass
    spans = tr.spans
    assert [s["name"] for s in spans] == ["inner", "mid", "mid2", "outer"]
    by = {s["name"]: s for s in spans}
    assert by["outer"]["parent"] == -1 and by["outer"]["depth"] == 0
    assert by["mid"]["parent"] == by["outer"]["id"]
    assert by["inner"]["parent"] == by["mid"]["id"]
    assert by["inner"]["depth"] == 2
    assert by["mid2"]["parent"] == by["outer"]["id"]
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert by["inner"]["ts"] + by["inner"]["dur"] \
        <= by["outer"]["ts"] + by["outer"]["dur"] + 1e-9


def test_tags_at_open_and_late_tag():
    tr = tracer.Tracer()
    with tr.span("s", bucket=3, phase="encode") as sp:
        sp.tag(rounds=7)
    (s,) = tr.spans
    assert s["tags"] == {"bucket": 3, "phase": "encode", "rounds": 7}


def test_sync_marks_tensors_and_nested_values():
    tr = tracer.Tracer()
    with tr.span("s") as sp:
        out = sp.sync(torch.arange(8) * 2)
    assert torch.equal(out, torch.arange(8) * 2)
    with tr.span("nested") as sp:
        sp.sync({"a": [1, (None, torch.ones(2))]})
    with tr.span("t"):
        pass
    with tr.span("none") as sp:
        sp.sync(None)
    with tr.span("no-tensor") as sp:
        sp.sync((3, "x", [None]))
    assert [s["synced"] for s in tr.spans] == [True, True, False, False, False]


class _Work:
    """Stands in for a torch.distributed work handle."""

    def __init__(self):
        self.waited = 0

    def is_completed(self):
        return self.waited > 0

    def wait(self):
        self.waited += 1
        return True


def test_sync_waits_on_work_handles():
    tr = tracer.Tracer()
    work = _Work()
    with tr.span("collective") as sp:
        sp.sync((work, 5))
    assert work.waited == 1 and tr.spans[0]["synced"] is True


def test_sync_waits_on_a_real_async_collective(tmp_path):
    """An ``async_op=True`` all-reduce on a one-rank gloo group: the span's
    sync waits on its handle, and the sum has landed when the span ends."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        t = torch.arange(4, dtype=torch.int32)
        tr = tracer.Tracer()
        with tr.span("bucketer.collective", phase="collective") as sp:
            work = dist.all_reduce(t, async_op=True)
            sp.sync((work, t))
        assert work.is_completed() and tr.spans[0]["synced"] is True
        assert torch.equal(t, torch.arange(4, dtype=torch.int32))
    finally:
        dist.destroy_process_group()


def test_threads_get_independent_stacks():
    tr = tracer.Tracer()
    done = threading.Event()

    def worker():
        with tr.span("w"):
            done.wait(1.0)

    t = threading.Thread(target=worker)
    with tr.span("main"):
        t.start()
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    by = {s["name"]: s for s in tr.spans}
    assert by["w"]["parent"] == -1
    assert by["w"]["tid"] != by["main"]["tid"]


def test_ring_capacity_drops_oldest():
    tr = tracer.Tracer(capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [s["name"] for s in tr.spans] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped == 6
    tr.clear()
    assert tr.spans == [] and tr.dropped == 0
    with pytest.raises(ValueError, match="capacity"):
        tracer.Tracer(capacity=0)


# ---------------------------------------------------------------------------
# the global switch and the disabled path
# ---------------------------------------------------------------------------


def test_global_enable_disable_round_trip():
    assert not trace.enabled()
    assert trace.span("x") is tracer.NULL_SPAN
    tr = trace.enable()
    assert trace.enabled() and trace.get() is tr
    with trace.span("y", k=1):
        pass
    assert tr.spans[0]["name"] == "y"
    trace.disable()
    assert not trace.enabled()
    with trace.span("z"):
        pass
    assert len(tr.spans) == 1


def test_null_span_is_falsy_noop():
    sp = trace.span("whatever", a=1)
    assert not sp
    with sp as inner:
        inner.tag(b=2)
        assert inner.sync(123) == 123


@pytest.fixture
def clock_reads(monkeypatch):
    """Counts the tracer's clock reads."""
    calls = []
    real = tracer.perf_counter

    def counting():
        calls.append(1)
        return real()

    monkeypatch.setattr(tracer, "perf_counter", counting)
    return calls


def test_disabled_path_reads_no_clock(clock_reads):
    """The disabled hot path (instead of the reference's wall-clock bound):
    no clock read, no record, the shared singleton, on direct spans and
    through every instrumented seam of a bucketed aggregation and a switch
    run."""
    assert not trace.enabled()
    before = len(trace.get().spans)
    for _ in range(1000):
        with trace.span("hot", phase="encode") as sp:
            sp.sync(torch.ones(1))
    tree = {f"l{i}": torch.randn(n) for i, n in enumerate((4096, 777, 2048))}
    Aggregator(AggConfig(bucket_bytes=4096)).allreduce_tree(tree)
    Aggregator(AggConfig(strategy="switch_emu")).allreduce(torch.randn(300))
    assert clock_reads == []
    assert len(trace.get().spans) == before
    # enabled, the same code reads the clock twice per span
    tr = trace.enable()
    Aggregator(AggConfig(bucket_bytes=4096)).allreduce_tree(tree)
    assert len(clock_reads) == 2 * len(tr.spans) > 0


# ---------------------------------------------------------------------------
# export: one schema for both packages
# ---------------------------------------------------------------------------


def _recorded():
    tr = tracer.Tracer()
    with tr.span("a", phase="encode", elems=256) as sp:
        sp.sync(torch.ones(4))
        with tr.span("b", phase="collective", elems=256):
            pass
    return tr


def test_jsonl_round_trip_and_schema_header(tmp_path):
    tr = _recorded()
    path = tmp_path / "t.jsonl"
    export.write_jsonl(tr, path, extra_header={"run": "x"})
    header, spans = export.read_jsonl(path)
    assert header["schema"] == tracer.SCHEMA_VERSION == jtrace.SCHEMA_VERSION
    assert header["kind"] == "repro-trace" and header["clock"] == "perf_counter"
    assert header["run"] == "x"
    assert spans == json.loads(json.dumps(tr.spans))


def test_each_package_reads_the_others_jsonl(tmp_path):
    port = _recorded()
    export.write_jsonl(port, tmp_path / "port.jsonl")
    head, spans = jtrace.read_jsonl(tmp_path / "port.jsonl")
    assert head == export.header() == jtrace.export.header()
    assert spans == json.loads(json.dumps(port.spans))

    ref = jtrace.Tracer()
    with ref.span("r", phase="finish", elems=512) as sp:
        sp.tag(bucket=1)
    jtrace.write_jsonl(ref, tmp_path / "ref.jsonl")
    head, spans = export.read_jsonl(tmp_path / "ref.jsonl")
    assert head["kind"] == "repro-trace" and spans == json.loads(json.dumps(ref.spans))
    assert set(spans[0]) == set(port.spans[0])  # the same span fields


def test_read_jsonl_rejects_wrong_kind_and_schema(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"kind": "not-a-trace", "schema": 1}\n')
    with pytest.raises(ValueError, match="kind"):
        export.read_jsonl(p)
    p.write_text('{"kind": "repro-trace", "schema": 999}\n')
    with pytest.raises(ValueError, match="schema"):
        export.read_jsonl(p)
    p.write_text("")
    with pytest.raises(ValueError, match="empty"):
        export.read_jsonl(p)


def test_chrome_export_equals_the_references(tmp_path):
    tr = tracer.Tracer()
    with tr.span("outer", phase="finish"):
        with tr.span("inner"):
            pass
    doc = export.to_chrome(tr)
    assert doc == jtrace.to_chrome(tr.spans)
    events = doc["traceEvents"]
    assert {e["name"] for e in events} == {"outer", "inner"}
    for e in events:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    assert next(e for e in events if e["name"] == "outer")["cat"] == "finish"
    path = export.write_chrome(tr, tmp_path / "t.chrome.json")
    assert json.load(open(path))["traceEvents"]


# ---------------------------------------------------------------------------
# instrumented seams
# ---------------------------------------------------------------------------


def test_aggregator_facade_emits_spans():
    trace.enable()
    Aggregator(AggConfig(strategy="fpisa")).allreduce(torch.ones(256))
    sp = next(s for s in trace.get().spans if s["name"] == "agg.allreduce")
    assert sp["tags"] == {"strategy": "fpisa", "stacked": False, "backend": "torch"}
    assert sp["synced"] is True


def test_bucketed_tree_emits_phase_spans_in_dispatch_order():
    """encode(i) -> finish(i-1) -> collective(i), each synced, tagged with
    its bucket, size and dtype group; generic strategies emit dispatch."""
    tree = {"a": torch.randn(700), "b": torch.randn(300), "c": torch.randn(5)}
    tr = trace.enable()
    Aggregator(AggConfig(bucket_bytes=2048)).allreduce_tree(tree)
    phases = [(s["tags"]["phase"], s["tags"]["bucket"]) for s in tr.spans
              if s["name"].startswith("bucketer.")]
    n = max(b for _, b in phases) + 1
    want = [("encode", 0), ("collective", 0)]
    for i in range(1, n):
        want += [("encode", i), ("finish", i - 1), ("collective", i)]
    assert phases == want + [("finish", n - 1)]
    for s in tr.spans:
        if s["name"].startswith("bucketer."):
            assert s["synced"] and s["tags"]["group"] == "float32"
            assert s["tags"]["elems"] % 256 == 0
    top = next(s for s in tr.spans if s["name"] == "agg.allreduce_tree")
    assert top["tags"]["bucket_bytes"] == 2048 and top["synced"]

    tr = trace.enable()
    Aggregator(AggConfig(strategy="switchml", bucket_bytes=2048)).allreduce_tree(tree)
    assert {s["name"] for s in tr.spans} >= {"bucketer.dispatch", "bucketer.finish"}
    assert "bucketer.encode" not in {s["name"] for s in tr.spans}


def test_switchsim_rounds_tag_equals_the_references():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3, 500)).astype(np.float32)
    kw = dict(num_workers=3, num_slots=4, elems_per_packet=32)
    trace.enable()
    tsw.run_aggregation(tsw.NumpyDataplane(tsw.DataplaneConfig(**kw)), vecs,
                        drop_prob=0.2, seed=1)
    jtrace.enable()
    try:
        jax_run_aggregation(JaxNumpyDataplane(JaxDataplaneConfig(**kw)), vecs,
                            drop_prob=0.2, seed=1)
        (ref,) = [s for s in jtrace.get().spans if s["name"] == "switchsim.run_aggregation"]
    finally:
        jtrace.disable()
    (got,) = [s for s in trace.get().spans if s["name"] == "switchsim.run_aggregation"]
    assert got["tags"]["phase"] == "switch" and got["tags"]["rounds"] >= 2
    for key in ("phase", "rounds", "workers", "nchunks", "drop_prob"):
        assert got["tags"][key] == ref["tags"][key], key


def test_cli_session_writes_jsonl_and_chrome(tmp_path, capsys):
    ap = argparse.ArgumentParser()
    trace.add_trace_args(ap)
    assert not trace.from_args(ap.parse_args([])).enabled
    for name in ("t.jsonl", "t.chrome.json"):
        session = trace.from_args(ap.parse_args(["--trace-out", str(tmp_path / name),
                                                 "--trace-capacity", "8"]))
        assert trace.enabled() and trace.get().capacity == 8
        Aggregator(AggConfig()).allreduce(torch.ones(512))
        assert session.finish() == str(tmp_path / name)
        assert not trace.enabled()
    assert jtrace.read_jsonl(tmp_path / "t.jsonl")[1]
    assert json.load(open(tmp_path / "t.chrome.json"))["traceEvents"]
    session = trace.from_args(ap.parse_args(["--trace"]))
    assert session.finish() is None
    assert "spans recorded" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the train step's phases (train/step.py), device intervals, the profiler
# ---------------------------------------------------------------------------

PHASES = ["train.forward_backward", "agg.allreduce_tree", "train.optimizer"]
STEP_KINDS = {"plain": {}, "accum_steps=2": {"accum_steps": 2},
              "logical_workers=2": {"logical_workers": 2}}


def _tiny_step(**step_kw):
    """One CPU train step of a one-layer smoke qwen (4 x 16 tokens, fpisa)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), num_layers=1)
    model = build(cfg, device=torch.device("cpu"))
    opt_cfg = optimizers.OptConfig()
    step = make_train_step(model, AggConfig(strategy="fpisa"), opt_cfg, 4, **step_kw)
    state = optimizers.init(list(model.parameters()), opt_cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(0))
    return lambda: step(state, {"tokens": tokens})


@pytest.mark.parametrize("kind", sorted(STEP_KINDS))
def test_train_step_emits_its_phases_in_order(kind):
    """train.step holds forward+backward, the aggregation and the optimizer,
    in that order, as its children; none of the three waits or tags."""
    run = _tiny_step(**STEP_KINDS[kind])
    tr = trace.enable()
    run()
    trace.disable()
    spans = tr.spans
    (top,) = [s for s in spans if s["name"] == "train.step"]
    assert top["parent"] == -1 and top["depth"] == 0
    kids = sorted((s for s in spans if s["parent"] == top["id"]), key=lambda s: s["ts"])
    assert [s["name"] for s in kids] == PHASES
    for a, b in zip(kids, kids[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for s in kids:
        assert s["depth"] == 1
        assert top["ts"] <= s["ts"] and s["ts"] + s["dur"] <= top["ts"] + top["dur"]
    fwd_bwd, _, opt = kids
    for s in (top, fwd_bwd, opt):
        assert s["tags"] == {} and s["synced"] is False


def test_train_step_with_the_tracer_off_reads_no_clock(clock_reads):
    run = _tiny_step()
    before = list(trace.get().spans)
    run()
    assert clock_reads == []
    assert trace.get().spans == before


def _profiled(run, tmp_path) -> list:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    prof.export_chrome_trace(str(tmp_path / "p.json"))
    return json.load(open(tmp_path / "p.json"))["traceEvents"]


def test_profiler_sees_the_phases_with_the_tracer_off(tmp_path):
    """With the tracer off and torch.profiler on, each span opens a
    record_function range: the phases are user annotations of the
    profiler's own trace, nested as the spans are, and the tracer records
    nothing."""
    run = _tiny_step()
    before = list(trace.get().spans)
    events = _profiled(run, tmp_path)
    assert not trace.enabled() and trace.get().spans == before
    ranges = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", *PHASES} <= set(ranges)
    top = ranges["train.step"]
    for name in PHASES:
        e = ranges[name]
        assert top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"]
    order = [ranges[n]["ts"] for n in PHASES]
    assert order == sorted(order)
    # the null path is back once the profiler stops
    assert trace.span("train.step") is tracer.NULL_SPAN


def test_profiler_and_tracer_on_record_both(tmp_path):
    run = _tiny_step()
    tr = trace.enable()
    events = _profiled(run, tmp_path)
    trace.disable()
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"train.step", *PHASES} <= names
    assert {"train.step", *PHASES} <= {s["name"] for s in tr.spans}


def test_cpu_spans_carry_no_device_fields():
    run = _tiny_step()
    tr = trace.enable()
    run()
    trace.disable()
    assert tr.spans and all("dev_ts" not in s and "dev_dur" not in s for s in tr.spans)
    doc = export.to_chrome(tr)
    assert {e["pid"] for e in doc["traceEvents"]} == {0}
    assert all(e["ph"] == "X" for e in doc["traceEvents"])


class _Event:
    """Stands in for torch.cuda.Event: each record advances a device clock
    by 1 ms; counts how many were made."""

    clock_ms = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self):
        type(self).clock_ms += 1.0
        self.t = type(self).clock_ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA as the tracer sees it, without a card: ``started`` says whether
    CUDA has started, events come from ``_Event``."""
    state = {"started": True}
    monkeypatch.setattr(_Event, "clock_ms", 0.0)
    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(tracer.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tracer.torch.cuda, "is_initialized", lambda: state["started"])
    monkeypatch.setattr(tracer.torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(tracer.torch.cuda, "Event", _Event)
    return state


def test_device_intervals_resolve_on_the_anchor_clock(fake_cuda):
    tr = tracer.Tracer()
    t_anchor = tr._anchor[1]                       # device clock 1 ms
    with tr.span("outer"):                         # opens at 2 ms
        with tr.span("inner"):                     # 3 .. 4 ms
            pass
    assert len(tr._pending) == 2                   # nothing resolved on the hot path
    by = {s["name"]: s for s in tr.spans}
    assert by["inner"]["dev_ts"] == pytest.approx(t_anchor + 2e-3)
    assert by["inner"]["dev_dur"] == pytest.approx(1e-3)
    assert by["outer"]["dev_ts"] == pytest.approx(t_anchor + 1e-3)
    assert by["outer"]["dev_dur"] == pytest.approx(3e-3)
    assert not tr._pending and len(tr._free) == 4
    made = _Event.made
    with tr.span("again"):                         # events come from the pool
        pass
    assert _Event.made == made and tr.spans[-1]["dev_dur"] == pytest.approx(1e-3)


def test_device_intervals_on_the_device_row_and_in_jsonl(fake_cuda, tmp_path):
    tr = tracer.Tracer()
    with tr.span("outer", phase="finish"):
        with tr.span("inner"):
            pass
    doc = export.to_chrome(tr)
    dev = {e["name"]: e for e in doc["traceEvents"]
           if e["ph"] == "X" and e["pid"] == export.DEVICE_PID}
    host = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X" and e["pid"] == 0}
    assert set(dev) == set(host) == {"outer", "inner"}
    for s in tr.spans:
        assert dev[s["name"]]["ts"] == pytest.approx(s["dev_ts"] * 1e6)
        assert dev[s["name"]]["dur"] == pytest.approx(s["dev_dur"] * 1e6)
        assert dev[s["name"]]["cat"] == host[s["name"]]["cat"]
    assert {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"} \
        == {"host", "device (CUDA stream)"}
    export.write_jsonl(tr, tmp_path / "d.jsonl")
    head, spans = jtrace.read_jsonl(tmp_path / "d.jsonl")
    assert head["schema"] == 1 and spans == json.loads(json.dumps(tr.spans))
    assert all({"dev_ts", "dev_dur"} <= set(s) for s in spans)


def test_device_anchor_waits_for_cuda_to_start(fake_cuda):
    fake_cuda["started"] = False
    tr = tracer.Tracer()
    with tr.span("before"):
        pass
    assert tr._anchor is None and _Event.made == 0
    fake_cuda["started"] = True
    with tr.span("after"):
        pass
    before, after = tr.spans
    assert "dev_ts" not in before and after["dev_dur"] == pytest.approx(1e-3)
    assert tr._anchor is not None


def test_finished_events_are_retired_without_a_wait(fake_cuda, monkeypatch):
    monkeypatch.setattr(tracer, "_PENDING", 8)
    tr = tracer.Tracer()
    for _ in range(20):
        with tr.span("s"):
            pass
    assert len(tr._pending) <= 8 and len(tr._free) >= 2
    assert _Event.made < 2 * 20
    assert all("dev_dur" in s for s in tr.spans)


def test_disabled_path_makes_no_event(fake_cuda):
    assert not trace.enabled()
    for _ in range(100):
        with trace.span("hot"):
            pass
    assert _Event.made == 0
