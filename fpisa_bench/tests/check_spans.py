"""The readers of the program's phase spans (``fwd_bwd_ms.train``,
``optimizer_ms.train``) on the CPU: spans planted in a fresh global tracer
of the program, read through a stub run of the training cell.

Run from the repository root:
    PYTHONPATH=src python -m pytest -q fpisa_bench/tests/check_spans.py
"""
from __future__ import annotations

import pytest
import torch

from fpisa_bench import common, spec

READERS = {"fwd_bwd_ms.train": "train.forward_backward",
           "optimizer_ms.train": "train.optimizer"}


@pytest.fixture
def ptrace():
    from repro_torch import trace

    yield trace
    trace.disable()


def _run():
    return common.Run(spec.Cell("qwen_train_4k"), 0, 0.0, True, torch.device("cpu"))


def _plant(ptrace, steps: list) -> None:
    """One traced step a dict of {span name: device seconds} (None: the span
    holds no device interval), each phase inside ``train.step``, then the
    tracer off with its spans kept, as the training cell leaves it."""
    tracer = ptrace.enable()
    for step in steps:
        with ptrace.span("train.step"):
            for name in ("train.forward_backward", "agg.allreduce_tree", "train.optimizer"):
                if name in step:
                    with ptrace.span(name):
                        pass
    ptrace.disable()
    named = [s for s in tracer.spans if s["name"] != "train.step"]
    for s, dur in zip(named, (d for step in steps for d in step.values())):
        if dur is not None:
            s["dev_dur"] = dur


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_the_mean_device_time_in_ms(ptrace, metric):
    span = READERS[metric]
    _plant(ptrace, [{"train.forward_backward": 0.360, "agg.allreduce_tree": 0.006,
                     "train.optimizer": 0.034},
                    {"train.forward_backward": 0.350, "agg.allreduce_tree": 0.007,
                     "train.optimizer": 0.032}])
    want = {"train.forward_backward": 355.0, "train.optimizer": 33.0}[span]
    assert spec.metric_reader(metric).read(_run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_nothing_without_its_span(ptrace, metric):
    reader = spec.metric_reader(metric)
    ptrace.enable()
    ptrace.disable()
    assert reader.read(_run()) is None  # a fresh tracer holds nothing
    _plant(ptrace, [{"agg.allreduce_tree": 0.006}])  # a program without phase spans
    assert reader.read(_run()) is None
    _plant(ptrace, [{"train.forward_backward": None, "agg.allreduce_tree": None,
                     "train.optimizer": None}])  # spans without device intervals
    assert reader.read(_run()) is None


def test_readers_are_entries_of_the_training_cell():
    cell = spec.Cell("qwen_train_4k")
    entries = {m["name"]: m for m in cell.per_layer}
    for metric in READERS:
        reader = spec.metric_reader(metric)
        assert entries[metric]["source"] == reader.SOURCE == "program_span"
        assert entries[metric]["moves"] == reader.MOVES == "train_tok_s"
    assert not set(READERS) & {m["name"] for m in spec.Cell("qwen_agg_w4").per_layer}
