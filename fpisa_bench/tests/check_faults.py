"""Each fault a cell can have, planted under a whole run of the harness on
the CPU (the look for a card skipped, the small cell of ``small.py``), and
``correct`` coming out false; the same run without the fault comes out
true. Limits are the cells' own (``limits/<workload>.json``)."""
from __future__ import annotations

import pytest

from fpisa_bench.calibrate import half_batch
from fpisa_bench.tests.small import run_cpu, small_cell


def test_sound_runs_are_correct():
    for workload in ("qwen_train_4k", "qwen_agg_w4"):
        r = run_cpu(small_cell(workload))
        assert r.correct and r.failed == 0 and r.window.count > 0, (workload, r.checks)


def test_training_state_left_unchanged(monkeypatch):
    from repro_torch.optim import optimizers

    monkeypatch.setattr(optimizers, "update",
                        lambda params, grads, state, cfg: (state, {"grad_norm": 0.0}))
    r = run_cpu(small_cell("qwen_train_4k"))
    assert not r.correct
    assert r.checks["grad_gap"][0] == pytest.approx(1.0)
    assert r.checks["change_gap"][0] == pytest.approx(1.0)


def test_training_half_batch_left_out():
    with half_batch():
        r = run_cpu(small_cell("qwen_train_4k"))
    assert not r.correct, r.checks


def _planted(monkeypatch, fault):
    from repro_torch.core.agg import Aggregator

    plain = Aggregator.allreduce_tree
    monkeypatch.setattr(Aggregator, "allreduce_tree", lambda self, tree: fault(plain, self, tree))
    return run_cpu(small_cell("qwen_agg_w4"))


def _altered(plain, self, tree):
    out = plain(self, tree)
    leaf = out["layers.mlp.wi"]
    leaf.view(-1)[17] = -leaf.view(-1)[17] + 1.0
    return out


AGG_FAULTS = {
    "input returned unchanged": lambda plain, self, tree: tree,
    "half the workers, the sum doubled": lambda plain, self, tree: {
        k: 2 * v for k, v in plain(self, {k: v[: v.shape[0] // 2] for k, v in tree.items()}).items()},
    "the exchange left out, one worker's leaf": lambda plain, self, tree: {
        k: v[0] * v.shape[0] for k, v in tree.items()},
    "one answer altered": _altered,
}


@pytest.mark.parametrize("fault", sorted(AGG_FAULTS))
def test_aggregation_fault(monkeypatch, fault):
    r = _planted(monkeypatch, AGG_FAULTS[fault])
    assert not r.correct and r.checks["mismatched_elements"][0] > 0
