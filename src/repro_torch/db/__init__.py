"""Distributed query processing with in-switch FPISA operators (port of
``repro.db``): ``query`` holds the Top-N pruner, the group-by aggregators
and the Spark-like full-scan baselines."""
