"""Small copies of the benchmark's cells for the CPU checks: each cell's
own configuration and mix files, cut to a size the CPU runs in seconds
(the program on its plain torch backend)."""
from __future__ import annotations

import torch

from fpisa_bench import common, spec

SIZES = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=128, num_hidden_layers=2, vocab_size=512)


def small_cell(workload: str, dtype: str = "float32") -> spec.Cell:
    cell = spec.Cell(workload)
    cell.config = dict(cell.config, **SIZES, program=dict(
        cell.config["program"], param_dtype=dtype, activation_dtype=dtype, attn_q_chunk=32))
    traffic = dict(cell.traffic)
    if traffic["kind"] == "train":
        traffic.update(batch=2, seq=64, pool=4)
    else:
        traffic.update(inputs=2, sample_calls=[2, 4])
    cell.traffic = traffic
    return cell


def run_cpu(cell: spec.Cell, seed: int = 3, seconds: float = 0.3) -> common.Run:
    r = common.Run(cell, seed, seconds, False, torch.device("cpu"))
    spec.kind(cell.traffic["kind"]).run(r, cell.limits())
    return r
