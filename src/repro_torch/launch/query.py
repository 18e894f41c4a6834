"""Query-processing launcher of the port (torch counterpart of
``examples/query_processing.py``): distributed FP query processing with
in-switch FPISA operators (paper Sec. 6) on a uservisits-like table — Top-N
pruning and group-by aggregation of the FP32 ``adRevenue`` column, each held
to a Spark-like full-scan baseline on the host.

The table is the example's: ``adRevenue`` drawn as gamma(2, 50) in float32
and a country key in [0, 32) from numpy seed 1. The switch side runs on the
card unless ``--device cpu``; without a card it raises.

  PYTHONPATH=src python -m repro_torch.launch.query --device cpu
  PYTHONPATH=src python -m repro_torch.launch.query --rows 50000000
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.db import query as q

COUNTRIES = 32


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--rows", type=int, default=100_000, help="rows of the table")
    ap.add_argument("--group-rows", type=int, default=20_000,
                    help="rows of the group-by (a prefix of the table)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    rng = np.random.default_rng(1)
    ad_revenue = rng.gamma(2.0, 50.0, args.rows).astype(np.float32)
    country = rng.integers(0, COUNTRIES, args.rows)
    print(f"uservisits: {args.rows:,} rows, FP32 adRevenue column; switch on {name}\n")

    # SELECT TOP 10 adRevenue  (in-switch pruning, FPISA comparison)
    t0 = time.perf_counter()
    pruner = q.TopNPruner(n=10, device=dev)
    surv = pruner.run(ad_revenue, batch=4096)
    top10 = np.sort(ad_revenue[surv])[::-1][:10]
    t_topn = time.perf_counter() - t0
    exact = q.spark_like_topn(ad_revenue, 10)
    if not np.array_equal(top10, exact):
        raise AssertionError(f"Top-10 differs from the full scan: {top10} vs {exact}")
    print(f"Top-10: switch pruned {pruner.stats.prune_rate:.1%} of the stream "
          f"({pruner.stats.rows_out:,} rows reached the master) — exact result; "
          f"{t_topn:.3f} s")

    # SELECT country, SUM(adRevenue) GROUP BY country (in-switch aggregation)
    sub = slice(0, args.group_rows)
    t0 = time.perf_counter()
    agg = q.GroupBySum(num_slots=COUNTRIES, variant="full", device=dev)
    got = agg.run(country[sub], ad_revenue[sub])
    t_group = time.perf_counter() - t0
    exact_g = q.spark_like_groupby(country[sub], ad_revenue[sub])
    worst = max(abs(got[k] - v) / v for k, v in exact_g.items())
    print(f"Group-by SUM: only {agg.stats.rows_out} aggregates left the switch "
          f"(from {agg.stats.rows_in:,} rows); worst rel err {worst:.2e}; {t_group:.3f} s")
    print("\npaper claim: 1.9-2.7x over Spark from exactly this data reduction")


if __name__ == "__main__":
    main()
