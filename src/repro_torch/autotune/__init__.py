"""Cost-model autotuning of the aggregation schedule (torch port of
``repro.autotune``).

Pipeline: record phase spans (``repro_torch.trace`` /
``profile.profile_phases``) -> fit the per-phase affine cost model
(``costmodel.fit``) -> sweep candidate bucket plans
(``search.choose_bucket_bytes``) -> surface as ``--bucket-bytes auto``
(resolved in ``AggConfig.from_args`` via ``search.auto_bucket_bytes``).
"""
from repro_torch.autotune.costmodel import (  # noqa: F401
    PHASES, CostModel, PhaseCost, fit, fit_from_jsonl,
)
from repro_torch.autotune.profile import probe_sizes, profile_phases  # noqa: F401
from repro_torch.autotune.search import (  # noqa: F401
    DEFAULT_AUTO_BUCKET_BYTES, TRACE_ENV, auto_bucket_bytes,
    candidate_bucket_bytes, choose_bucket_bytes, plan_sizes,
    predict_tree_time, reference_leaves,
)
