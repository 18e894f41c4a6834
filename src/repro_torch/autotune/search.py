"""Bucket-plan search: sweep candidate ``bucket_bytes`` against the cost
model and surface the winner as ``--bucket-bytes auto`` (torch port of
``repro.autotune.search``).

The search scores each candidate by building the EXACT static plan the
bucketer would build (``core.bucketer.make_plan``: same block alignment,
same dtype grouping, same dispatch order) and pushing its bucket sizes
through :meth:`CostModel.pipeline_time`. Candidate 0 (the per-leaf path) is
scored over the block-padded leaf sizes, so auto can fall back to per-leaf
when the model says bucketing would lose.

``auto_bucket_bytes`` is the ``AggConfig.from_args`` hook: it fits the model
from the trace named by ``--autotune-trace`` / $REPRO_AUTOTUNE_TRACE and,
lacking any trace, falls back LOUDLY (a ``UserWarning``) to the reference's
measured-good default rather than guessing silently.
"""
from __future__ import annotations

import math
import os
import warnings
from typing import Sequence

import torch

from repro_torch.autotune import costmodel
from repro_torch.core.bucketer import make_plan

# the reference's measured-good plan (its fig11 benchmark: 4 MiB buckets
# beat per-leaf at full size), the loud-fallback choice when no trace exists
DEFAULT_AUTO_BUCKET_BYTES = 4 << 20

TRACE_ENV = "REPRO_AUTOTUNE_TRACE"

# synthetic reference workload for the CLI path, where the gradient tree is
# not known yet at flag-parsing time: a ragged fp32 parameter list (big ffn /
# medium attn / tiny non-block-multiple norm per layer), about 16M elements
_REFERENCE_ELEMS = 1 << 24
_REFERENCE_LAYER = (16384, 4096, 777)


def _ceil_to(n: int, q: int) -> int:
    return -(-n // q) * q


def _numel(leaf) -> int:
    return int(math.prod(leaf.shape)) if len(leaf.shape) else 1


def candidate_bucket_bytes(total_bytes: int, *, lo: int = 1 << 16,
                           hi: int = 32 << 20) -> tuple[int, ...]:
    """Power-of-two sweep from ``lo`` up to the workload size (capped at
    ``hi``), plus 0 for the per-leaf path."""
    cands, b = [0], lo
    top = min(hi, max(_ceil_to(total_bytes, lo), lo))
    while b < top:
        cands.append(b)
        b <<= 1
    cands.append(top)
    return tuple(dict.fromkeys(cands))


def plan_sizes(leaves: Sequence, *, block: int,
               bucket_bytes: int) -> list[int]:
    """Bucket element counts, in dispatch order, of the plan this
    ``bucket_bytes`` would produce (0 = per-leaf: each float leaf is its own
    'bucket', block-padded, in the same reverse-flatten dispatch order)."""
    if bucket_bytes:
        plan = make_plan(leaves, block=block, bucket_bytes=bucket_bytes)
        return [b.elems for b in plan.buckets]
    sizes = []
    for leaf in reversed(list(leaves)):
        n = _numel(leaf)
        if n and leaf.dtype.is_floating_point:
            sizes.append(_ceil_to(n, block))
    return sizes


def predict_tree_time(model: costmodel.CostModel, leaves: Sequence, *,
                      block: int, bucket_bytes: int) -> float:
    return model.pipeline_time(
        plan_sizes(leaves, block=block, bucket_bytes=bucket_bytes))


def choose_bucket_bytes(model: costmodel.CostModel, leaves: Sequence, *,
                        block: int,
                        candidates: Sequence[int] | None = None
                        ) -> tuple[int, dict[int, float]]:
    """Sweep candidates; returns (best bucket_bytes, {candidate: predicted
    seconds}). Ties break toward the smaller plan (less transient memory)."""
    if candidates is None:
        total = sum((_numel(l) or 1) * l.dtype.itemsize for l in leaves)
        candidates = candidate_bucket_bytes(total)
    scores = {
        int(c): predict_tree_time(model, leaves, block=block,
                                  bucket_bytes=int(c))
        for c in candidates}
    best = min(sorted(scores), key=lambda c: scores[c])
    return best, scores


def reference_leaves(total_elems: int = _REFERENCE_ELEMS) -> list[torch.Tensor]:
    """The synthetic workload as data-free ``device="meta"`` tensors."""
    leaves, total = [], 0
    while total < total_elems:
        for n in _REFERENCE_LAYER:
            leaves.append(torch.empty((n,), dtype=torch.float32, device="meta"))
            total += n
    return leaves


def auto_bucket_bytes(*, trace_path: str | None = None, block: int = 256,
                      leaves: Sequence | None = None) -> int:
    """Resolve ``--bucket-bytes auto`` to a concrete byte count.

    Fits the cost model from ``trace_path`` (or $REPRO_AUTOTUNE_TRACE) and
    sweeps the candidate plans for ``leaves`` (tensors, e.g. ``device="meta"``
    ones; the synthetic reference workload when the tree is not known at flag
    time). With no trace available this warns loudly and returns the
    measured-good default: auto never silently degrades into a guess."""
    path = trace_path or os.environ.get(TRACE_ENV)
    if not path or not os.path.exists(path):
        warnings.warn(
            f"--bucket-bytes auto: no autotune trace "
            f"({'missing file ' + repr(path) if path else 'none given via --autotune-trace or $' + TRACE_ENV}); "
            f"falling back to the measured default "
            f"{DEFAULT_AUTO_BUCKET_BYTES} bytes. Record one with "
            f"--trace-out or repro_torch.autotune.profile_phases.",
            UserWarning, stacklevel=2)
        return DEFAULT_AUTO_BUCKET_BYTES
    model = costmodel.fit_from_jsonl(path)
    if leaves is None:
        leaves = reference_leaves()
    best, _ = choose_bucket_bytes(model, leaves, block=block)
    return best
