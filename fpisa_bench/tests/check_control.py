"""The controls, at each cell's own size on the card (``cuda``; they skip
without one): the plain reference computed in fp8 in the program's place
fails the training cell's comparison, and the program's FPISA path in the
bf16 format fails the aggregation cell's. ``fpisa_bench.calibrate`` reads
the same controls over several seeds to set the limits.

    PYTHONPATH=src python -m pytest -q -m cuda fpisa_bench/tests/check_control.py
"""
from __future__ import annotations

import pytest
import torch

from fpisa_bench import calibrate, spec

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


def test_training_control_in_fp8_fails():
    _card()
    cell = spec.Cell("qwen_train_4k")
    sound = calibrate.one_run(cell, 41, 0.0)
    assert sound.correct, sound.checks
    gaps = calibrate.control_train(cell, 41, sound.readings["reference"])
    limits = cell.limits()
    assert any(v > limits[k] for k, v in gaps.items()), gaps


def test_aggregation_control_in_the_bf16_format_fails():
    _card()
    cell = spec.Cell("qwen_agg_w4")
    cell.traffic = dict(cell.traffic, agg=dict(cell.traffic["agg"], fmt_name="bf16"))
    r = calibrate.one_run(cell, 42, 1.0)
    assert not r.correct and r.checks["mismatched_elements"][0] > 0
